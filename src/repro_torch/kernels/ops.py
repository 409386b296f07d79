"""Public wrappers for the ported kernels (counterpart of
``repro.kernels.ops``).

Dispatch is by the device of the input: a tensor on the CPU goes to the
kernel's plain PyTorch version, a tensor on the card launches the Hopper
kernel (or raises). There is no fallback from one to the other.

Conventions kept from the reference:

* **Runtime scales.** Every scale and zero-point is a tensor (or number)
  passed at call time, never a compile-time constant, so fresh
  calibrations and per-layer scales never rebuild a kernel.
* **Batched + ragged shapes.** Wrappers accept ``(..., K)`` inputs: leading
  dims are flattened into rows and the result is reshaped back. The
  kernels mask their edges, so no row padding is needed.
* ``z_a`` requires a weight colsum; when the caller gives none it is
  computed from the int8 weights (never from packed bytes).
"""
from __future__ import annotations

from repro_torch.kernels import _args
from repro_torch.kernels import fused_ln_quant as _lnq
from repro_torch.kernels import int8_matmul as _imm
from repro_torch.kernels import peg_quant as _peg
from repro_torch.kernels.ref import w_colsum_groups


def _rows(x):
    """(..., D) -> ((M, D), lead shape)."""
    return x.reshape(-1, x.shape[-1]), x.shape[:-1]


def _unrows(y, lead):
    return y.reshape(*lead, y.shape[-1])


def _pick(x, plain, cuda):
    return cuda if _args.device_kind(x) == "cuda" else plain


def rms_quantize(x, gamma, scale, zp, *, qmin: int = 0, qmax: int = 255,
                 eps: float = 1e-6):
    x2, lead = _rows(x)
    fn = _pick(x, _lnq.rms_quantize_plain, _lnq.rms_quantize_cuda)
    return _unrows(fn(x2, gamma, scale, zp, qmin=qmin, qmax=qmax, eps=eps),
                   lead)


def peg_quantize(x, scales, zps, *, qmin: int = 0, qmax: int = 255):
    x2, lead = _rows(x)
    fn = _pick(x, _peg.peg_quantize_plain, _peg.peg_quantize_cuda)
    return _unrows(fn(x2, scales, zps, qmin=qmin, qmax=qmax), lead)


def int8_matmul(a_q, w_q, *, s_a, s_w, z_a=None, w_colsum=None, bias=None,
                mul=None, activation: str = "none", out_scale=None,
                out_zp=None, qmin: int = -128, qmax: int = 127,
                w_bits: int = 8):
    """Per-tensor int8 matmul (+ fused epilogue) over (..., K) activations.
    ``mul`` has the output's leading shape."""
    if z_a is not None and w_colsum is None:
        if w_bits == 4:
            raise ValueError("w_bits=4 with z_a requires explicit w_colsum "
                             "(colsum over packed bytes is meaningless)")
        w_colsum = w_colsum_groups(w_q, 1)[0]
    a2, lead = _rows(a_q)
    mul2 = None if mul is None else _rows(mul)[0]
    fn = _pick(a_q, _imm.int8_matmul_plain, _imm.int8_matmul_cuda)
    out = fn(a2, w_q, s_a, s_w, z_a=z_a, w_colsum=w_colsum, bias=bias,
             mul=mul2, activation=activation, out_scale=out_scale,
             out_zp=out_zp, qmin=qmin, qmax=qmax, w_bits=w_bits)
    return _unrows(out, lead)


def int8_matmul_peg(a_q, w_q, act_scales, act_zps, *, w_scale,
                    w_colsum=None, bias=None, mul=None,
                    activation: str = "none", out_scale=None, out_zp=None,
                    qmin: int = -128, qmax: int = 127, w_bits: int = 8):
    """PEG fixed-point matmul: the per-group re-scalings fused into the
    K loop. ``w_colsum`` (G, N) is computed here when not supplied."""
    g = act_scales.shape[0]
    if w_colsum is None:
        if w_bits == 4:
            raise ValueError("w_bits=4 requires explicit w_colsum")
        w_colsum = w_colsum_groups(w_q, g)
    a2, lead = _rows(a_q)
    mul2 = None if mul is None else _rows(mul)[0]
    fn = _pick(a_q, _imm.int8_matmul_peg_plain, _imm.int8_matmul_peg_cuda)
    out = fn(a2, w_q, act_scales, act_zps, w_scale, w_colsum, bias=bias,
             mul=mul2, activation=activation, out_scale=out_scale,
             out_zp=out_zp, qmin=qmin, qmax=qmax, w_bits=w_bits)
    return _unrows(out, lead)
