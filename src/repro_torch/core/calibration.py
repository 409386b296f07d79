"""Quantization context + static-range calibration (port of
``repro.core.calibration``).

Models thread a ``QuantCtx`` through their forward pass and call
``ctx.act(site, x)`` at every activation site, ``ctx.act_in`` at the
matmul-input sites (``{L}/attn_in``, ``{L}/attn/wo_in``) and
``ctx.weight(site, w)`` on every weight read. Modes:

  OFF     — passthrough;
  COLLECT — record range statistics (and calibration tensors) per site;
  APPLY   — simulated quantization with the frozen act state;
  QAT     — simulated quantization with *learnable* scale / offset read
            from ``qat_params`` (see ``core.qat``) on every call, so a
            trainer that swaps the leaves each step is seen at once;
  DEPLOY  — true fixed-point execution: models route deployable matmuls
            through the integer kernels (``core.deploy``) using
            ``ctx.deploy_acts``; every other site falls back to APPLY
            fake-quant so deployed and simulated runs stay comparable.

A weight that reaches ``ctx.weight`` without frozen params is estimated from
its values. With a ``weight_cache`` dict (shared by every ctx of one serving
session) the fake-quantized weight is computed once per weight instead of
on every call — same values, no per-step MSE search. A tensor-parallel
rank holds slices of its weights, whose grids must be the whole weights':
its memo is filled before the weights are placed
(``parallel.sharding.seed_weight_memo``), and ``memo_only`` makes a miss
raise instead of fitting a grid to a slice. A rank that trains on its
slices refits every weight's grid each step (``weight_split``): on the
whole weight, through collectives over the ranks that cut it
(``range_estimation.estimate_weight_params(split=)``).

Quant-health telemetry: with ``telemetry`` a dict (a
:class:`SiteTelemetry`), every APPLY / DEPLOY site records its
``[n_clipped, n_total, amax, cal_range]`` vector there before it
quantizes (``telem_site``); the step builders of ``runtime.steps`` return
the dict as an extra output. None (the default) leaves the forward as it
is. Under a rank mesh the forward marks (``mark_cut``) the sites whose
tensor is this rank's part of one cut over ``model`` (their counts add
over the ranks); any other site's tensor is whole on every rank (counted
once).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, Optional

import torch

from repro_torch.core import peg as peg_lib
from repro_torch.core.quant_config import Granularity, QuantizationPolicy
from repro_torch.core.quantizer import (QuantParams, fake_quant,
                                        telemetry_stats)
from repro_torch.core.range_estimation import (RangeState,
                                               estimate_weight_params,
                                               finalize, init_range_state,
                                               observe)


class Mode(enum.Enum):
    OFF = "off"
    COLLECT = "collect"
    APPLY = "apply"
    QAT = "qat"
    DEPLOY = "deploy"


QuantState = Dict[str, QuantParams]


class SiteTelemetry(dict):
    """One armed step's ``{site: [clipped, total, amax, cal_range]}``
    vectors, and ``parts``: the sites whose tensor this rank holds a part
    of, cut over the ``model`` axis (``runtime.engine`` adds their counts
    over the ranks and counts every other site once)."""

    def __init__(self):
        super().__init__()
        self.parts = set()


@dataclasses.dataclass
class QuantCtx:
    policy: QuantizationPolicy
    mode: Mode = Mode.OFF
    act_state: Optional[QuantState] = None       # APPLY / DEPLOY
    weight_state: Optional[QuantState] = None    # APPLY (PTQ-frozen weights)
    qat_params: Optional[dict] = None            # QAT learnable (core.qat)
    range_states: Dict[str, RangeState] = dataclasses.field(
        default_factory=dict)                    # COLLECT outputs
    calib_tensors: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)
    keep_tensors: bool = True                    # needed for MSE / PEG
    deploy_acts: Optional[dict] = None           # DEPLOY: site -> ActQuant
    collect_inputs: bool = False                 # COLLECT the act_in sites
    weight_cache: Optional[dict] = None          # APPLY / DEPLOY memo
    telemetry: Optional[Dict[str, torch.Tensor]] = None  # site -> (4,)
    memo_only: bool = False                      # sharded: no grid fits
    # (dist, {site: dim}): the weight read at the site is this rank's
    # slice of its dim over ``model``; its grid is the whole weight's
    weight_split: Optional[tuple] = None

    @staticmethod
    def memo_key(site: str, w: torch.Tensor) -> tuple:
        """The ``weight_cache`` key of ``w`` read at ``site``: the view
        itself (storage address, shape, strides, dtype, device)."""
        return (site, w.data_ptr(), tuple(w.shape), tuple(w.stride()),
                w.dtype, w.device)

    def telem_site(self, site: str, vec: torch.Tensor) -> None:
        """Accumulate one site's [clipped, total, amax, range] vector:
        counts add, amax and range take the max, so a site hit again in
        one forward folds into one vector."""
        if self.telemetry is None:
            return
        prev = self.telemetry.get(site)
        if prev is not None:
            vec = torch.cat([prev[:2] + vec[:2],
                             torch.maximum(prev[2:], vec[2:])])
        self.telemetry[site] = vec

    def _observe(self, site, x, cfg):
        prev = self.range_states.get(site, init_range_state())
        self.range_states[site] = observe(prev, x, cfg)
        if self.keep_tensors:
            self.calib_tensors[site] = x

    def _apply(self, site, x, cfg):
        qp = self.act_state.get(site) if self.act_state else None
        if qp is None:
            return x
        if self.telemetry is not None:
            with torch.no_grad():       # a side record, outside autograd
                self.telem_site(site, telemetry_stats(x, qp, cfg))
        return fake_quant(x, qp, cfg)

    def mark_cut(self, *sites: str) -> None:
        """The tensors that ``sites`` just recorded are this rank's parts of
        tensors cut over ``model``: their counts add over the ranks
        (``SiteTelemetry.parts``). A no-op without telemetry, and for a
        site that recorded nothing."""
        if self.telemetry is not None:
            self.telemetry.parts.update(s for s in sites
                                        if s in self.telemetry)

    def act(self, site: str, x: torch.Tensor) -> torch.Tensor:
        cfg = self.policy.act_config(site)
        if self.mode == Mode.OFF or not cfg.enabled:
            return x
        if self.mode == Mode.COLLECT:
            self._observe(site, x, cfg)
            return x
        if self.mode == Mode.QAT:
            from repro_torch.core import qat as qat_lib
            return qat_lib.apply_act(self, site, x, cfg)
        return self._apply(site, x, cfg)

    def act_in(self, site: str, x: torch.Tensor) -> torch.Tensor:
        """Matmul-input sites: no-op unless the deploy calibration
        collected them."""
        cfg = self.policy.act_config(site)
        if not cfg.enabled or self.mode in (Mode.OFF, Mode.QAT):
            return x
        if self.mode == Mode.COLLECT:
            if self.collect_inputs:
                self._observe(site, x, cfg)
            return x
        return self._apply(site, x, cfg)

    def deploy_act(self, site: str):
        """ActQuant for a deployable matmul-input site (DEPLOY mode only)."""
        if self.mode != Mode.DEPLOY or not self.deploy_acts:
            return None
        return self.deploy_acts.get(site)

    def fit_weight(self, site: str, w: torch.Tensor,
                   cfg) -> QuantParams:
        """The grid of the weight ``w`` read at ``site``, estimated from
        its values: the whole weight's where ``weight_split`` cuts it."""
        split = None
        if self.weight_split is not None:
            dist, dims = self.weight_split
            if site in dims:
                split = (dist, dims[site])
        return estimate_weight_params(w, cfg, split)

    def weight(self, site: str, w: torch.Tensor) -> torch.Tensor:
        cfg = self.policy.weight_config(site)
        if self.mode in (Mode.OFF, Mode.COLLECT) or not cfg.enabled:
            return w
        if self.mode == Mode.QAT:
            from repro_torch.core import qat as qat_lib
            return qat_lib.apply_weight(self, site, w, cfg)
        qp = (self.weight_state or {}).get(site)
        if qp is not None:
            return fake_quant(w, qp, cfg)
        if self.weight_cache is None:
            return fake_quant(w, self.fit_weight(site, w, cfg), cfg)
        key = self.memo_key(site, w)
        hit = self.weight_cache.get(key)
        if hit is None and self.memo_only:
            raise RuntimeError(
                f"{site}: a sharded weight reached ctx.weight without the "
                "fake-quant of its whole weight (parallel.sharding."
                "seed_weight_memo fills the memo before placing)")
        if hit is None:
            # keep ``w`` alive with its result so its storage (the key) is
            # never reused by another tensor while the entry exists
            hit = (w, fake_quant(w, estimate_weight_params(w, cfg), cfg))
            self.weight_cache[key] = hit
        return hit[1]


# ---------------------------------------------------------------------------
# Calibration loop
# ---------------------------------------------------------------------------

def collect_ranges(forward: Callable, params, batches,
                   policy: QuantizationPolicy, *, keep_tensors: bool = True,
                   collect_inputs: bool = False):
    """Run ``forward(params, batch, ctx)`` over calibration batches; returns
    (range_states, calib_tensors), keeping the last batch's tensors."""
    range_states: Dict[str, RangeState] = {}
    calib_tensors: Dict[str, torch.Tensor] = {}
    with torch.no_grad():
        for batch in batches:
            ctx = QuantCtx(policy=policy, mode=Mode.COLLECT,
                           range_states=dict(range_states),
                           keep_tensors=keep_tensors,
                           collect_inputs=collect_inputs)
            forward(params, batch, ctx)
            range_states = ctx.range_states
            calib_tensors.update(ctx.calib_tensors)
    return range_states, calib_tensors


def build_act_state(range_states, calib_tensors,
                    policy: QuantizationPolicy, *, tp_shards: int = 1):
    """Finalize collected statistics into a frozen act state; PEG sites also
    get their group spec (range-based permutation). Returns
    (act_state, peg_specs)."""
    act_state: QuantState = {}
    peg_specs: Dict[str, peg_lib.PEGSpec] = {}
    for site, state in range_states.items():
        cfg = policy.act_config(site)
        if not cfg.enabled:
            continue
        if cfg.granularity == Granularity.PER_EMBEDDING_GROUP:
            ranges = (state.x_max - state.x_min).cpu().numpy()
            spec = peg_lib.build_groups(ranges, cfg.num_groups,
                                        use_permutation=cfg.use_permutation,
                                        tp_shards=tp_shards)
            peg_specs[site] = spec
            gi = torch.from_numpy(
                peg_lib.group_index_natural_layout(spec)).to(
                    state.x_min.device)
            qp = finalize(state, cfg, calib_tensors.get(site),
                          group_index=gi)
        else:
            qp = finalize(state, cfg, calib_tensors.get(site))
        act_state[site] = qp
    return act_state, peg_specs


def build_weight_state(params_named, policy: QuantizationPolicy) -> QuantState:
    """Quantization params for every named weight (site -> tensor)."""
    state: QuantState = {}
    for site, w in params_named.items():
        cfg = policy.weight_config(site)
        if not cfg.enabled or cfg.bits >= 32:
            continue
        state[site] = estimate_weight_params(w, cfg)
    return state

