"""RMSNorm fused with the int8 emit (the paper's Fig.-4 quantizer placed
directly after the norm), for ``Mode.DEPLOY`` matmul inputs.

``rms_quantize_cuda`` launches the Hopper kernel in
``csrc/norm_quant.cu`` (port of ``repro.kernels.fused_ln_quant.
rms_quantize``); ``rms_quantize_plain`` repeats its arithmetic in PyTorch
and serves CPU tensors and the on-card comparison. Both take ``x`` as
``(T, d)`` f32 or bf16, ``gamma`` ``(d,)`` (the RMSNorm affine is
``1 + gamma``), and ``(G,)`` scales / zero-points over contiguous ``d/G``
column spans (G = 1 is per-tensor).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _args, _build


def rms_quantize_plain(x, gamma, scale, zp, *, qmin: int, qmax: int,
                       eps: float = 1e-6) -> torch.Tensor:
    d = x.shape[-1]
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * (1.0 + gamma.float())
    s = _args.expand_groups(scale, d, x.device)
    z = _args.expand_groups(zp, d, x.device)
    return torch.clamp(torch.round(y / s) + z, qmin, qmax).to(torch.int8)


def rms_quantize_cuda(x, gamma, scale, zp, *, qmin: int, qmax: int,
                      eps: float = 1e-6) -> torch.Tensor:
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"rms_quantize: x must be (T, d) f32/bf16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    _args.on_cuda(x)
    x = x.contiguous()
    t, d = x.shape
    dev = x.device
    g = _args.f32(gamma, dev, d, "gamma")
    s = _args.f32(scale, dev, what="scale")
    z = _args.f32(zp, dev, s.numel(), "zero-point")
    if d % s.numel():
        raise ValueError(f"rms_quantize: {s.numel()} groups do not divide "
                         f"d={d}")
    out = torch.empty((t, d), dtype=torch.int8, device=dev)
    threads = 256 if d >= 256 else 32 * ((d + 31) // 32)
    _build.check(_build.lib("norm_quant").rms_quantize(
        x.data_ptr(), int(x.dtype == torch.bfloat16), g.data_ptr(),
        s.data_ptr(), z.data_ptr(), out.data_ptr(), t, d, s.numel(),
        float(eps), qmin, qmax, threads, _args.stream()), "rms_quantize")
    rms_quantize_cuda.launches += 1
    return out


rms_quantize_cuda.launches = 0
