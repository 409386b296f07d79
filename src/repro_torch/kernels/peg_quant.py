"""Per-embedding-group quantize (paper eq. 5): ports of
``repro.kernels.peg_quant``, one Hopper kernel (``csrc/peg_quant.cu``) with
one switch.

* ``peg_quantize`` (K4): the int8 emit in front of an integer matmul whose
  input is not a norm output (the attention ``wo`` input).
* ``peg_fake_quant`` (K10): the same grid returning ``(q − z)·s`` in x's
  dtype.

``*_cuda`` launch the kernel (each counts its launches); ``*_plain`` repeat
its arithmetic in PyTorch. ``x`` is ``(T, d)`` f32 or bf16, group-sorted;
scales / zero-points ``(G,)`` over contiguous ``d/G`` spans.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _args, _build


def _quant_plain(x, scales, zps, *, qmin, qmax, emit):
    d = x.shape[-1]
    s = _args.expand_groups(scales, d, x.device)
    z = _args.expand_groups(zps, d, x.device)
    q = torch.clamp(torch.round(x.float() / s) + z, qmin, qmax)
    return q.to(torch.int8) if emit else ((q - z) * s).to(x.dtype)


def peg_quantize_plain(x, scales, zps, *, qmin: int, qmax: int
                       ) -> torch.Tensor:
    return _quant_plain(x, scales, zps, qmin=qmin, qmax=qmax, emit=True)


def peg_fake_quant_plain(x, scales, zps, *, qmin: int, qmax: int
                         ) -> torch.Tensor:
    return _quant_plain(x, scales, zps, qmin=qmin, qmax=qmax, emit=False)


def _launch(what, x, scales, zps, *, qmin, qmax, emit):
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: x must be (T, d) f32/bf16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    _args.on_cuda(x)
    x = x.contiguous()
    t, d = x.shape
    s = _args.f32(scales, x.device, what="scales")
    z = _args.f32(zps, x.device, s.numel(), "zero-points")
    if d % s.numel():
        raise ValueError(f"{what}: {s.numel()} groups do not divide d={d}")
    out = torch.empty((t, d), dtype=torch.int8 if emit else x.dtype,
                      device=x.device)
    width = 16 // x.element_size()     # elements in a 16-byte vector
    vec = int(d % width == 0 and (d // s.numel()) % width == 0
              and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    _build.check(_build.lib("peg_quant").peg_quant(
        x.data_ptr(), int(x.dtype == torch.bfloat16), s.data_ptr(),
        z.data_ptr(), out.data_ptr(), t * d, d, s.numel(), qmin, qmax, vec,
        int(emit), _args.stream()), what)
    return out


def peg_quantize_cuda(x, scales, zps, *, qmin: int, qmax: int
                      ) -> torch.Tensor:
    out = _launch("peg_quantize", x, scales, zps, qmin=qmin, qmax=qmax,
                  emit=True)
    peg_quantize_cuda.launches += 1
    return out


def peg_fake_quant_cuda(x, scales, zps, *, qmin: int, qmax: int
                        ) -> torch.Tensor:
    out = _launch("peg_fake_quant", x, scales, zps, qmin=qmin, qmax=qmax,
                  emit=False)
    peg_fake_quant_cuda.launches += 1
    return out


peg_quantize_cuda.launches = 0
peg_fake_quant_cuda.launches = 0
