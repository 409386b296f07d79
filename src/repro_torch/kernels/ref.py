"""Dequantize-then-compute oracles for the ported kernels (PyTorch twins of
``repro.kernels.ref``): independent of the kernels' integer arithmetic, so
tests can hold both the plain versions and the kernels against them."""
from __future__ import annotations

import torch

from repro_torch.kernels._args import expand_groups
from repro_torch.kernels.fused_ln_quant import \
    rms_quantize_plain as rms_quantize_ref  # noqa: F401  (same arithmetic)
from repro_torch.kernels.int8_matmul import epilogue
from repro_torch.kernels.peg_quant import \
    peg_quantize_plain as peg_quantize_ref  # noqa: F401  (same arithmetic)


def epilogue_ref(f, *, bias=None, activation="none", mul=None,
                 out_scale=None, out_zp=None, qmin=-128, qmax=127):
    """Reference for the fused epilogue: bias -> act -> mul -> requant."""
    return epilogue(f.float(), bias=bias, activation=activation, mul=mul,
                    out_scale=out_scale, out_zp=out_zp, qmin=qmin, qmax=qmax)


def int8_matmul_fused_ref(a_q, w_q, s_a, s_w, *, z_a=None, bias=None,
                          activation="none", mul=None, out_scale=None,
                          out_zp=None, qmin=-128, qmax=127):
    """Per-tensor asymmetric dequant-matmul + epilogue oracle."""
    dev = a_q.device
    a = a_q.float()
    if z_a is not None:
        a = a - torch.as_tensor(z_a, dtype=torch.float32, device=dev)
    f = (a * torch.as_tensor(s_a, dtype=torch.float32, device=dev)) @ \
        (w_q.float() * torch.as_tensor(s_w, dtype=torch.float32, device=dev))
    return epilogue_ref(f, bias=bias, activation=activation, mul=mul,
                        out_scale=out_scale, out_zp=out_zp, qmin=qmin,
                        qmax=qmax)


def int8_matmul_peg_fused_ref(a_q, w_q, act_scales, act_zps, w_scale, *,
                              bias=None, activation="none", mul=None,
                              out_scale=None, out_zp=None, qmin=-128,
                              qmax=127):
    """PEG dequant-matmul + epilogue oracle."""
    k = a_q.shape[-1]
    s = expand_groups(act_scales, k, a_q.device)
    z = expand_groups(act_zps, k, a_q.device)
    a_hat = (a_q.float() - z) * s
    w_hat = w_q.float() * torch.as_tensor(w_scale, dtype=torch.float32,
                                          device=a_q.device)
    return epilogue_ref(a_hat @ w_hat, bias=bias, activation=activation,
                        mul=mul, out_scale=out_scale, out_zp=out_zp,
                        qmin=qmin, qmax=qmax)


def w_colsum_groups(w_q, num_groups):
    """(G, N) per-group column sums of int8 weights (zero-point correction),
    always from the unpacked integer values."""
    k, n = w_q.shape
    gs = k // num_groups
    return w_q.reshape(num_groups, gs, n).to(torch.int32).sum(
        dim=1, dtype=torch.int32)
