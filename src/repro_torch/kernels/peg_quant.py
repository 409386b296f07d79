"""Per-embedding-group quantize (the int8 emit of paper eq. 5): the
quantize in front of an integer matmul whose input is not a norm output
(the attention ``wo`` input).

``peg_quantize_cuda`` launches the Hopper kernel in ``csrc/peg_quant.cu``
(port of ``repro.kernels.peg_quant.peg_quantize``); ``peg_quantize_plain``
repeats its arithmetic in PyTorch. ``x`` is ``(T, d)`` f32 or bf16,
group-sorted; scales / zero-points ``(G,)`` over contiguous ``d/G`` spans.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _args, _build


def peg_quantize_plain(x, scales, zps, *, qmin: int, qmax: int
                       ) -> torch.Tensor:
    d = x.shape[-1]
    s = _args.expand_groups(scales, d, x.device)
    z = _args.expand_groups(zps, d, x.device)
    return torch.clamp(torch.round(x.float() / s) + z, qmin,
                       qmax).to(torch.int8)


def peg_quantize_cuda(x, scales, zps, *, qmin: int, qmax: int
                      ) -> torch.Tensor:
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"peg_quantize: x must be (T, d) f32/bf16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    _args.on_cuda(x)
    x = x.contiguous()
    t, d = x.shape
    s = _args.f32(scales, x.device, what="scales")
    z = _args.f32(zps, x.device, s.numel(), "zero-points")
    if d % s.numel():
        raise ValueError(f"peg_quantize: {s.numel()} groups do not divide "
                         f"d={d}")
    out = torch.empty((t, d), dtype=torch.int8, device=x.device)
    vec = int(x.dtype == torch.float32 and d % 4 == 0
              and x.data_ptr() % 16 == 0)
    _build.check(_build.lib("peg_quant").peg_quantize(
        x.data_ptr(), int(x.dtype == torch.bfloat16), s.data_ptr(),
        z.data_ptr(), out.data_ptr(), t * d, d, s.numel(), qmin, qmax, vec,
        _args.stream()), "peg_quantize")
    peg_quantize_cuda.launches += 1
    return out


peg_quantize_cuda.launches = 0
