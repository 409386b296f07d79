"""Integer-path deployment (``Mode.DEPLOY``; port of ``repro.core.deploy``):
serve quantized models through the integer kernels instead of simulating
quantization in f32.

* Weights are quantized ONCE into packed payloads — ``{"q": int8 (K, N),
  "s": f32 (), "colsum": int32 (G, N)}``, or at 4 bits ``{"q4": int8
  (K/2, N) pairwise-row nibbles, "s", "colsum"}`` with the colsum of the
  unpacked values — kept in the param dict, so the stacked layout slices
  per-layer payloads exactly like f32 weights.
* Activations travel between kernels as :class:`QTensor` int8 payloads; the
  FFN chain runs as ``rms_quantize`` -> ``int8_matmul_peg`` (fused epilogue)
  -> ``int8_matmul``.
* The PEG permutation is folded into the packed weight rows and the norm
  affine, so groups are contiguous spans at run time.
* Asymmetric uint8 grids are shifted by -128 onto int8 (``q8 = q - 128``,
  ``z8 = z - 128`` leave ``s * (q - z)`` unchanged).

Models dispatch on ``is_packed(weight)`` / ``isinstance(x, QTensor)``; a site
the kernels cannot express (non-uniform PEG groups, non-8-bit activations,
4-bit weights with an odd K or PEG group, per-channel hidden scales) stays
on the fake-quant path, site by site.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.quant_config import (Granularity, QuantizationPolicy,
                                           QuantizerConfig)
from repro_torch.core.quantizer import TINY, QuantParams
from repro_torch.core.range_estimation import estimate_weight_params
from repro_torch.kernels import ops
from repro_torch.kernels.nibble import pack_rows
from repro_torch.kernels.ref import w_colsum_groups

_SHIFT = 128


class QTensor(NamedTuple):
    """An int8 activation payload between kernels: ``q`` (..., K) int8 in the
    layout its consumer expects, ``scales``/``zps`` (G,) f32 on the shifted
    int8 grid (G = 1: per-tensor)."""
    q: torch.Tensor
    scales: torch.Tensor
    zps: torch.Tensor

    @property
    def shape(self):
        return self.q.shape


@dataclasses.dataclass(frozen=True)
class ActQuant:
    """Deploy-side quantizer for one matmul-input site."""
    scales: torch.Tensor            # (G,) f32
    zps: torch.Tensor               # (G,) f32, shifted int8 grid
    qmin: int                       # shifted grid bounds
    qmax: int
    perm: Optional[torch.Tensor]    # (d,) PEG permutation or None

    @property
    def per_tensor(self) -> bool:
        return int(self.scales.shape[0]) == 1 and self.perm is None


class KVQuant(NamedTuple):
    """Calibrated per-head k/v grids (scale, shifted zero-point; (KV,) f32)
    for a quantized KV cache, registered under ``{prefix}/attn/kv``."""
    k_grid: torch.Tensor
    v_grid: torch.Tensor
    k_zp: torch.Tensor
    v_zp: torch.Tensor


def kv_quant_for(act_state, policy: QuantizationPolicy, attn_prefix: str,
                 num_kv_heads: int, bits: int = 8) -> Optional[KVQuant]:
    """Per-head k/v grids from calibrated per-tensor ``{prefix}/k`` and
    ``{prefix}/v`` sites at ``bits``; None for anything else."""
    grids = []
    for name in ("k", "v"):
        site = f"{attn_prefix}/{name}"
        qp = act_state.get(site)
        if qp is None:
            return None
        cfg = policy.act_config(site)
        if not cfg.enabled or cfg.bits != bits or qp.group_index is not None \
                or qp.scale.numel() != 1:
            return None
        scale = qp.scale.float().reshape(1)
        shift = 2 ** (bits - 1) if cfg.qmin == 0 else 0
        zp = qp.zero_point.float().reshape(1) - shift
        grids.append((scale.expand(num_kv_heads).clone(),
                      zp.expand(num_kv_heads).clone()))
    return KVQuant(k_grid=grids[0][0], v_grid=grids[1][0],
                   k_zp=grids[0][1], v_zp=grids[1][1])


def is_packed(w) -> bool:
    """True for a packed deployment weight payload (int8 ``q`` or
    nibble-packed int4 ``q4``)."""
    return isinstance(w, dict) and ("q" in w or "q4" in w) and "colsum" in w


def packed_summary(params) -> Tuple[int, int, int]:
    """(int8 payloads, int4 payloads, payload bytes) of the packed weights
    of a param dict; a stacked payload counts once per layer."""
    n8 = n4 = nbytes = 0

    def walk(node):
        nonlocal n8, n4, nbytes
        if is_packed(node):
            key = "q4" if "q4" in node else "q"
            q = node[key]
            layers = q.shape[0] if q.dim() == 3 else 1
            if key == "q4":
                n4 += layers
            else:
                n8 += layers
            nbytes += q.numel() * q.element_size()
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
    walk(params)
    return n8, n4, nbytes


# ---------------------------------------------------------------------------
# Building the deployment artifact
# ---------------------------------------------------------------------------

def act_quant_for(qp: QuantParams, cfg: QuantizerConfig
                  ) -> Optional[ActQuant]:
    """Fake-quant activation params -> deployable ActQuant, or None when the
    kernels cannot express the site."""
    if cfg.bits != 8:
        return None
    shift = _SHIFT if cfg.qmin == 0 else 0
    qmin, qmax = cfg.qmin - shift, cfg.qmax - shift
    scale = qp.scale.float().reshape(-1)
    zp = qp.zero_point.float().reshape(-1) - shift
    if qp.group_index is None:
        if scale.shape[0] != 1:          # per-channel/embedding: not packed
            return None
        return ActQuant(scales=scale, zps=zp, qmin=qmin, qmax=qmax, perm=None)
    gi = qp.group_index.cpu().numpy()
    counts = np.bincount(gi, minlength=scale.shape[0])
    if counts.min() != counts.max():     # the kernels need uniform groups
        return None
    perm = np.argsort(gi, kind="stable")
    perm_t = None if np.array_equal(perm, np.arange(gi.shape[0])) \
        else torch.from_numpy(perm).to(scale.device)
    return ActQuant(scales=scale, zps=zp, qmin=qmin, qmax=qmax, perm=perm_t)


def pack_linear(w, wcfg: QuantizerConfig, num_groups: int,
                perm: Optional[torch.Tensor] = None) -> Optional[dict]:
    """Quantize one weight (K, N) — or a stacked (L, K, N) — into the packed
    int + scale + per-group-colsum payload, rows permuted first when the
    consuming site uses the PEG permutation. The grid is exactly the
    simulate-path fake-quant grid. 8-bit configs give ``{"q", "s",
    "colsum"}``; 4-bit ones ``{"q4": (K/2, N) pairwise-row nibbles, "s",
    "colsum"}`` with the colsum of the unpacked values, and only for an
    even K and an even group size (else None: the site stays fake-quant)."""
    if not wcfg.enabled or wcfg.bits not in (4, 8) or not wcfg.symmetric \
            or wcfg.granularity != Granularity.PER_TENSOR:
        return None
    from repro_torch.models.common import resolve_weight
    w = resolve_weight(w).float()
    k_dim = w.shape[-2]
    if wcfg.bits == 4 and (k_dim % 2 or (k_dim // num_groups) % 2):
        return None

    def _pack_one(w2):
        if perm is not None:
            w2 = w2.index_select(0, perm)
        qp = estimate_weight_params(w2, wcfg)
        s = torch.clamp_min(qp.scale.float(), TINY)
        wq = torch.clamp(torch.round(w2 / s), wcfg.qmin,
                         wcfg.qmax).to(torch.int8)
        colsum = w_colsum_groups(wq, num_groups)
        if wcfg.bits == 4:
            return {"q4": pack_rows(wq), "s": s, "colsum": colsum}
        return {"q": wq, "s": s, "colsum": colsum}

    if w.dim() == 3:                     # stacked layout: per-layer pack
        per = [_pack_one(w[i]) for i in range(w.shape[0])]
        return {k: torch.stack([p[k] for p in per]) for k in per[0]}
    return _pack_one(w)


def _site(act_state, policy, name) -> Optional[ActQuant]:
    qp = act_state.get(name)
    if qp is None:
        return None
    return act_quant_for(qp, policy.act_config(name))


def _pack_ffn(bp: dict, prefix: str, policy: QuantizationPolicy,
              acts: Dict[str, ActQuant]) -> Optional[dict]:
    """Pack one block's FFN weights if every needed site deploys."""
    ffn = bp.get("ffn")
    if not isinstance(ffn, dict):
        return None
    in_aq = acts.get(f"{prefix}/ffn_in")
    hid_aq = acts.get(f"{prefix}/ffn/hidden")
    if in_aq is None or hid_aq is None or not hid_aq.per_tensor:
        return None
    if "w_gate" not in ffn:              # GLU only in this slice
        return None
    g_in = int(in_aq.scales.shape[0])
    names = [("w_gate", g_in, in_aq.perm), ("w_up", g_in, in_aq.perm),
             ("w_out", 1, None)]
    packed = dict(ffn)
    for name, g, perm in names:
        pk = pack_linear(ffn[name], policy.weight_config(
            f"{prefix}/ffn/{name}"), g, perm)
        if pk is None:
            return None
        packed[name] = pk
    return packed


def _pack_attn(bp: dict, prefix: str, policy: QuantizationPolicy,
               acts: Dict[str, ActQuant]) -> Optional[dict]:
    attn = bp.get("attn")
    if not isinstance(attn, dict):
        return None
    in_aq = acts.get(f"{prefix}/attn_in")
    wo_aq = acts.get(f"{prefix}/attn/wo_in")
    if in_aq is None or wo_aq is None or not in_aq.per_tensor \
            or not wo_aq.per_tensor:
        return None
    packed = dict(attn)
    for name in ("wq", "wk", "wv", "wo"):
        pk = pack_linear(attn[name], policy.weight_config(
            f"{prefix}/attn/{name}"), 1, None)
        if pk is None:
            return None
        packed[name] = pk
    return packed


def build_deploy(cfg, params, policy: QuantizationPolicy, act_state
                 ) -> Tuple[dict, Dict[str, ActQuant]]:
    """Pre-quantize every deployable linear of a transformer param dict.

    Returns (packed_params, deploy_acts): FFN / attention projection weights
    become packed payloads wherever the policy, the calibrated act state and
    the kernels allow (everything else stays for the fake-quant path);
    ``deploy_acts`` maps input sites to :class:`ActQuant`, plus
    ``{prefix}/attn/kv`` (and ``kv4``) -> :class:`KVQuant`. Works on both
    the stacked and the unrolled layouts."""
    acts: Dict = {}
    for name in act_state:
        aq = _site(act_state, policy, name)
        if aq is not None:
            acts[name] = aq

    def pack_block(bp, prefix):
        new = dict(bp)
        ffn = _pack_ffn(bp, prefix, policy, acts)
        if ffn is not None:
            new["ffn"] = ffn
        attn = _pack_attn(bp, prefix, policy, acts)
        if attn is not None:
            new["attn"] = attn
        if isinstance(bp.get("attn"), dict):
            for bits, key in ((8, "kv"), (4, "kv4")):
                kv = kv_quant_for(act_state, policy, f"{prefix}/attn",
                                  cfg.num_kv_heads, bits=bits)
                if kv is not None:
                    acts[f"{prefix}/attn/{key}"] = kv
        return new

    packed = dict(params)
    with torch.no_grad():
        if "scan" in params:
            packed["scan"] = [pack_block(bp, "layer") for bp in params["scan"]]
            packed["tail"] = [pack_block(bp, "tail") for bp in params["tail"]]
        if "layers" in params:
            packed["layers"] = [pack_block(bp, f"layer{i}")
                                for i, bp in enumerate(params["layers"])]
    return packed, acts


# ---------------------------------------------------------------------------
# Runtime entry points (called from repro_torch.models)
# ---------------------------------------------------------------------------

def norm_quantize(norm_kind: str, p_norm: dict, x, aq: ActQuant) -> QTensor:
    """Fused norm + int8 emit for a matmul input: ``rms_quantize`` (K1) or,
    for ``"layernorm"``, ``ln_quantize`` (K8). The PEG permutation, if any,
    is applied to the input and folded into the norm affine (γ and β)."""
    g = p_norm["g"]
    if aq.perm is not None:
        x = x.index_select(-1, aq.perm)
        g = g.index_select(0, aq.perm)
    if norm_kind == "layernorm":
        b = p_norm["b"]
        if aq.perm is not None:
            b = b.index_select(0, aq.perm)
        q = ops.ln_quantize(x, g, b, aq.scales, aq.zps, qmin=aq.qmin,
                            qmax=aq.qmax)
    else:
        q = ops.rms_quantize(x, g, aq.scales, aq.zps, qmin=aq.qmin,
                             qmax=aq.qmax)
    return QTensor(q=q, scales=aq.scales, zps=aq.zps)


def quantize_act(x, aq: ActQuant) -> QTensor:
    """Plain fused quantize (no norm) — the Wo input after attention."""
    if aq.perm is not None:
        x = x.index_select(-1, aq.perm)
    q = ops.peg_quantize(x, aq.scales, aq.zps, qmin=aq.qmin, qmax=aq.qmax)
    return QTensor(q=q, scales=aq.scales, zps=aq.zps)


def matmul(x: QTensor, packed: dict, *, bias=None, mul=None,
           activation: str = "none", out_aq: Optional[ActQuant] = None):
    """Integer matmul against a packed weight with the fused epilogue: G = 1
    inputs take the per-tensor kernel (eq. 3), grouped inputs the PEG kernel
    (eq. 4 -> 5), 4-bit ``q4`` payloads their ``w_bits=4`` variants. With
    ``out_aq`` the result is a requantized QTensor."""
    kw = dict(bias=bias, mul=mul, activation=activation)
    if out_aq is not None:
        kw.update(out_scale=out_aq.scales[0], out_zp=out_aq.zps[0],
                  qmin=out_aq.qmin, qmax=out_aq.qmax)
    if "q4" in packed:                   # row-packed int4 payload
        w_q = packed["q4"]
        kw["w_bits"] = 4
    else:
        w_q = packed["q"]
    if int(x.scales.shape[0]) == 1:
        out = ops.int8_matmul(x.q, w_q, s_a=x.scales[0],
                              s_w=packed["s"], z_a=x.zps[0],
                              w_colsum=packed["colsum"][0], **kw)
    else:
        out = ops.int8_matmul_peg(x.q, w_q, x.scales, x.zps,
                                  w_scale=packed["s"],
                                  w_colsum=packed["colsum"], **kw)
    if out_aq is not None:
        return QTensor(q=out, scales=out_aq.scales, zps=out_aq.zps)
    return out
