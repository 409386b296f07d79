"""Quantization configuration schema.

Mirrors the paper's experimental setup (§5): uniform affine quantization,
symmetric weights / asymmetric activations, static activation ranges. Every
quantizer in the network is described by a ``QuantizerConfig``; a
``QuantizationPolicy`` maps named tensor sites to configs (this is how the
paper's mixed-precision recipes and the PEG placement — "FFN input, output and
sum only" — are expressed).
"""
from __future__ import annotations

import dataclasses
import enum
import re
from typing import Mapping


class Granularity(enum.Enum):
    PER_TENSOR = "per_tensor"
    PER_CHANNEL = "per_channel"          # weights: one (s, z) per output channel
    PER_EMBEDDING = "per_embedding"      # activations: one (s, z) per embedding dim
    PER_EMBEDDING_GROUP = "per_embedding_group"  # the paper's PEG scheme


class RangeEstimator(enum.Enum):
    CURRENT_MINMAX = "current_minmax"    # min/max of the current batch
    RUNNING_MINMAX = "running_minmax"    # EMA of per-batch min/max
    MSE = "mse"                          # grid-search MSE-optimal clipping


@dataclasses.dataclass(frozen=True)
class QuantizerConfig:
    """Static description of one quantizer."""
    bits: int = 8
    symmetric: bool = False              # paper: weights sym, activations asym
    granularity: Granularity = Granularity.PER_TENSOR
    estimator: RangeEstimator = RangeEstimator.CURRENT_MINMAX
    num_groups: int = 1                  # K for PER_EMBEDDING_GROUP
    use_permutation: bool = False        # range-based permutation ("+P" rows of Table 5)
    ema_momentum: float = 0.9            # paper B.2 for running min-max
    mse_grid_points: int = 100           # candidate clipping ratios for MSE search
    channel_axis: int = -1               # axis carrying channels/embeddings
    enabled: bool = True

    def __post_init__(self):
        if self.bits < 1 or self.bits > 32:
            raise ValueError(f"unsupported bit-width {self.bits}")
        if self.granularity == Granularity.PER_EMBEDDING_GROUP and self.num_groups < 1:
            raise ValueError("PEG requires num_groups >= 1")

    @property
    def qmin(self) -> int:
        if self.symmetric:
            return -(2 ** (self.bits - 1)) + 1   # symmetric, restricted range
        return 0

    @property
    def qmax(self) -> int:
        if self.symmetric:
            return 2 ** (self.bits - 1) - 1
        return 2 ** self.bits - 1

    @property
    def num_levels(self) -> int:
        return self.qmax - self.qmin


# Disabled sentinel — keeps a site in the policy but passes values through.
FP32 = QuantizerConfig(bits=32, enabled=False)

# Paper defaults (§5): W8 symmetric per-tensor, A8 asymmetric per-tensor.
W8_DEFAULT = QuantizerConfig(bits=8, symmetric=True,
                             estimator=RangeEstimator.MSE)
A8_DEFAULT = QuantizerConfig(bits=8, symmetric=False,
                             estimator=RangeEstimator.RUNNING_MINMAX)
A16_DEFAULT = QuantizerConfig(bits=16, symmetric=False,
                              estimator=RangeEstimator.RUNNING_MINMAX)


def peg_config(num_groups: int = 6, *, bits: int = 8,
               use_permutation: bool = True,
               estimator: RangeEstimator = RangeEstimator.RUNNING_MINMAX,
               ) -> QuantizerConfig:
    """The paper's best PEG setting: K=6 with range-based permutation."""
    return QuantizerConfig(
        bits=bits, symmetric=False,
        granularity=Granularity.PER_EMBEDDING_GROUP,
        num_groups=num_groups, use_permutation=use_permutation,
        estimator=estimator)


@dataclasses.dataclass(frozen=True)
class QuantizationPolicy:
    """Maps tensor-site names (regex patterns) to quantizer configs.

    Sites are named hierarchically, e.g. ``layer/ffn_out``, ``layer/residual_ffn``,
    ``embed/tokens``, ``head/logits``. First matching pattern wins; ``default``
    applies otherwise. This is the mechanism behind the paper's recipes:

    - W8A8 baseline:      everything default.
    - MP-PTQ (Table 4):   ``.*residual_ffn|.*ffn_(in|out)|head/logits`` → 16-bit.
    - PEG-PTQ (Table 5):  ``.*ffn_(in|out)|.*residual_ffn`` → peg_config(K).
    """
    weight_default: QuantizerConfig = W8_DEFAULT
    act_default: QuantizerConfig = A8_DEFAULT
    weight_overrides: Mapping[str, QuantizerConfig] = dataclasses.field(default_factory=dict)
    act_overrides: Mapping[str, QuantizerConfig] = dataclasses.field(default_factory=dict)

    def weight_config(self, site: str) -> QuantizerConfig:
        return self._match(site, self.weight_overrides, self.weight_default)

    def act_config(self, site: str) -> QuantizerConfig:
        return self._match(site, self.act_overrides, self.act_default)

    @staticmethod
    def _match(site, overrides, default):
        for pattern, cfg in overrides.items():
            if re.fullmatch(pattern, site):
                return cfg
        return default


def fp32_policy() -> QuantizationPolicy:
    return QuantizationPolicy(weight_default=FP32, act_default=FP32)


def w8a8_policy(**kw) -> QuantizationPolicy:
    """Paper's baseline joint 8-bit PTQ (Table 1, row W8A8)."""
    return QuantizationPolicy(**kw)


def mixed_precision_policy(*, residual_bits: int = 16,
                           ffn_io_16bit: bool = True,
                           output_16bit: bool = True) -> QuantizationPolicy:
    """The paper's MP-PTQ recipe (Table 4: * residual sum, † FFN in/out,
    ‡ final output in 16-bit, MSE for the output)."""
    a16 = dataclasses.replace(A16_DEFAULT, bits=residual_bits)
    overrides = {r".*/residual_ffn": a16}
    if ffn_io_16bit:
        overrides[r".*/ffn_(in|out)"] = a16
    if output_16bit:
        overrides[r"head/.*"] = dataclasses.replace(
            a16, estimator=RangeEstimator.MSE)
    return QuantizationPolicy(act_overrides=overrides)


def peg_policy(num_groups: int = 6, *, use_permutation: bool = True,
               ffn_only: bool = True) -> QuantizationPolicy:
    """The paper's PEG-PTQ recipe (Table 5/6: K=6 + permutation applied to
    FFN's input, output and residual sum; everything else per-tensor)."""
    peg = peg_config(num_groups, use_permutation=use_permutation)
    if ffn_only:
        overrides = {r".*/(ffn_(in|out)|residual_ffn)": peg}
        return QuantizationPolicy(act_overrides=overrides)
    return QuantizationPolicy(act_default=peg)


def low_bit_weight_policy(weight_bits: int, *, act_bits: int = 32,
                          embedding_bits: int | None = None) -> QuantizationPolicy:
    """Table 7: low-bit weights (always MSE estimator per §5) and optional
    ultra-low-bit token embeddings."""
    w = QuantizerConfig(bits=weight_bits, symmetric=True,
                        estimator=RangeEstimator.MSE)
    w_over = {}
    if embedding_bits is not None:
        w_over[r"embed/tokens"] = QuantizerConfig(
            bits=embedding_bits, symmetric=True, estimator=RangeEstimator.MSE)
    act = A8_DEFAULT if act_bits == 8 else FP32
    return QuantizationPolicy(weight_default=w, act_default=act,
                              weight_overrides=w_over)
