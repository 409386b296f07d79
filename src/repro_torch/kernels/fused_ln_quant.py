"""RMSNorm / LayerNorm fused with quantization (the paper's Fig.-4
quantizer placed directly after the norm): ports of the four entry points
of ``repro.kernels.fused_ln_quant``, one Hopper kernel
(``csrc/norm_quant.cu``) with two switches.

* ``rms_quantize`` (K1): RMSNorm·(1 + gamma), int8 emit — every
  ``Mode.DEPLOY`` matmul input of an RMSNorm model.
* ``ln_quantize`` (K8): LayerNorm (x − μ)·rsqrt(var + eps)·gamma + beta,
  int8 emit — ``deploy.norm_quantize`` for LayerNorm models.
* ``rms_fake_quant`` / ``ln_fake_quant`` (K9a / K9b): the same norms
  returning ``(q − z)·s`` in x's dtype.

``*_cuda`` launch the kernel (each counts its launches); ``*_plain``
repeat its arithmetic in PyTorch and serve CPU tensors and the on-card
comparison. ``x`` is ``(T, d)`` f32 or bf16, ``gamma`` / ``beta`` ``(d,)``,
and ``(G,)`` scales / zero-points cover contiguous ``d/G`` column spans
(G = 1 is per-tensor).

The kernel cuts each row into C column slices, one block each, the C
blocks of a row one thread-block cluster (:func:`plan_row_split`); a
block's threads each hold ``nv`` vectors of 8 columns (:func:`row_threads`)
and the row statistics are exchanged through distributed shared memory.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _args, _build


def _normalize(x, gamma, beta, eps, ln):
    xf = x.float()
    if ln:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        xc = xf - mu
        var = torch.mean(xc * xc, dim=-1, keepdim=True)
        return xc * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return xf * torch.rsqrt(var + eps) * (1.0 + gamma.float())


def _quant_plain(x, gamma, beta, scale, zp, *, qmin, qmax, eps, ln, emit):
    d = x.shape[-1]
    y = _normalize(x, gamma, beta, eps, ln)
    s = _args.expand_groups(scale, d, x.device)
    z = _args.expand_groups(zp, d, x.device)
    q = torch.clamp(torch.round(y / s) + z, qmin, qmax)
    return q.to(torch.int8) if emit else ((q - z) * s).to(x.dtype)


def rms_quantize_plain(x, gamma, scale, zp, *, qmin: int, qmax: int,
                       eps: float = 1e-6) -> torch.Tensor:
    return _quant_plain(x, gamma, None, scale, zp, qmin=qmin, qmax=qmax,
                        eps=eps, ln=False, emit=True)


def ln_quantize_plain(x, gamma, beta, scale, zp, *, qmin: int, qmax: int,
                      eps: float = 1e-6) -> torch.Tensor:
    return _quant_plain(x, gamma, beta, scale, zp, qmin=qmin, qmax=qmax,
                        eps=eps, ln=True, emit=True)


def rms_fake_quant_plain(x, gamma, scale, zp, *, qmin: int, qmax: int,
                         eps: float = 1e-6) -> torch.Tensor:
    return _quant_plain(x, gamma, None, scale, zp, qmin=qmin, qmax=qmax,
                        eps=eps, ln=False, emit=False)


def ln_fake_quant_plain(x, gamma, beta, scale, zp, *, qmin: int, qmax: int,
                        eps: float = 1e-6) -> torch.Tensor:
    return _quant_plain(x, gamma, beta, scale, zp, qmin=qmin, qmax=qmax,
                        eps=eps, ln=True, emit=False)


SMS = 132                # streaming multiprocessors of an H100 SXM
ROW_VEC = 8              # columns per vector: 16 bytes of bf16, 8 of int8
MAX_ROW_SPLIT = 16       # Hopper's largest cluster
MIN_SLICE_COLS = 128     # columns a slice keeps before a row is cut again
MAX_ROW_THREADS = 512    # the kernel's block limit (csrc/norm_quant.cu)


def row_vectorizable(d, groups) -> bool:
    """Whether rows of ``d`` columns in ``groups`` PEG groups go in whole
    vectors of ``ROW_VEC`` columns, none straddling two groups."""
    return d % ROW_VEC == 0 and (d // groups) % ROW_VEC == 0


def plan_row_split(rows, d, groups) -> int:
    """C, the blocks (one cluster) that share a row of K1/K8/K9: the
    largest power of two up to 16 that keeps ``rows x C`` within about one
    wave (``SMS`` blocks), gives every block a whole number of vectors
    (:func:`row_vectorizable`) and at least 128 columns (below that the
    cluster barrier costs more than the bytes a split spreads). Rows that
    go in no whole vectors stay whole (C = 1)."""
    if not row_vectorizable(d, groups):
        return 1
    cap = max(1, min(-(-SMS // max(1, rows)), MAX_ROW_SPLIT))
    split = 1 << (cap.bit_length() - 1)
    while split > 1 and (d % (split * ROW_VEC) or
                         d // split < MIN_SLICE_COLS):
        split //= 2
    return split


def row_split_cols(d, split):
    """The [first, end) columns of each block of a row, as the kernel cuts
    them."""
    return [(r * d // split, (r + 1) * d // split) for r in range(split)]


def row_threads(cols, vec, split):
    """(vectors per thread, threads) of one block over ``cols`` columns in
    vectors of ``vec``: thread t holds vectors t, t + threads, ...; at most
    512 threads and 32 / C warps (a warp reads the C x W warp sums of the
    cluster one per lane), with as few vectors per thread as that allows
    (1, 2 or 4)."""
    nvec = -(-cols // vec)
    max_warps = min(MAX_ROW_THREADS // 32, 32 // split)
    for nv in (1, 2, 4):
        warps = -(-nvec // (32 * nv))
        if warps <= max_warps:
            return nv, 32 * warps
    raise ValueError(f"norm_quant kernel: a block of {cols} columns exceeds "
                     f"{4 * 32 * max_warps} vectors of {vec}")


def _launch(what, x, gamma, beta, scale, zp, *, qmin, qmax, eps, ln, emit):
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: x must be (T, d) f32/bf16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    _args.on_cuda(x)
    x = x.contiguous()
    t, d = x.shape
    dev = x.device
    g = _args.f32(gamma, dev, d, "gamma")
    b = _args.f32(beta, dev, d, "beta") if ln else None
    s = _args.f32(scale, dev, what="scale")
    z = _args.f32(zp, dev, s.numel(), "zero-point")
    if d % s.numel():
        raise ValueError(f"{what}: {s.numel()} groups do not divide d={d}")
    out = torch.empty((t, d), dtype=torch.int8 if emit else x.dtype,
                      device=dev)
    split = plan_row_split(t, d, s.numel())
    aligned = all(_args.ptr(v) % 16 == 0 for v in (x, g, b, out))
    vec = ROW_VEC if row_vectorizable(d, s.numel()) and aligned else 1
    nv, threads = row_threads(d // split, vec, split)
    _build.check(_build.lib("norm_quant").norm_quant(
        x.data_ptr(), int(x.dtype == torch.bfloat16), g.data_ptr(),
        _args.ptr(b), s.data_ptr(), z.data_ptr(), out.data_ptr(), t, d,
        s.numel(), float(eps), qmin, qmax, split, threads, nv, vec, int(ln),
        int(emit), _args.stream()), what)
    return out


def rms_quantize_cuda(x, gamma, scale, zp, *, qmin: int, qmax: int,
                      eps: float = 1e-6) -> torch.Tensor:
    out = _launch("rms_quantize", x, gamma, None, scale, zp, qmin=qmin,
                  qmax=qmax, eps=eps, ln=False, emit=True)
    rms_quantize_cuda.launches += 1
    return out


def ln_quantize_cuda(x, gamma, beta, scale, zp, *, qmin: int, qmax: int,
                     eps: float = 1e-6) -> torch.Tensor:
    out = _launch("ln_quantize", x, gamma, beta, scale, zp, qmin=qmin,
                  qmax=qmax, eps=eps, ln=True, emit=True)
    ln_quantize_cuda.launches += 1
    return out


def rms_fake_quant_cuda(x, gamma, scale, zp, *, qmin: int, qmax: int,
                        eps: float = 1e-6) -> torch.Tensor:
    out = _launch("rms_fake_quant", x, gamma, None, scale, zp, qmin=qmin,
                  qmax=qmax, eps=eps, ln=False, emit=False)
    rms_fake_quant_cuda.launches += 1
    return out


def ln_fake_quant_cuda(x, gamma, beta, scale, zp, *, qmin: int, qmax: int,
                       eps: float = 1e-6) -> torch.Tensor:
    out = _launch("ln_fake_quant", x, gamma, beta, scale, zp, qmin=qmin,
                  qmax=qmax, eps=eps, ln=True, emit=False)
    ln_fake_quant_cuda.launches += 1
    return out


rms_quantize_cuda.launches = ln_quantize_cuda.launches = 0
rms_fake_quant_cuda.launches = ln_fake_quant_cuda.launches = 0
