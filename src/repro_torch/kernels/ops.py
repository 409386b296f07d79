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
  computed from the int8 weights. Packed 4-bit weights (``w_bits=4``) must
  come with their colsum: a sum over packed bytes would be meaningless.
* Decode attention: absent zero-points are zeros (symmetric grids); a
  ragged dense S is padded to a multiple of ``chunk`` with empty cells, as
  the reference pads its grid (on the cell axis, so packed ``kv_bits=4``
  caches pad the same way); a paged table is cut to the columns the
  layer's capacity can reach (``_lane_blocks``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _args
from repro_torch.kernels import fused_ln_quant as _lnq
from repro_torch.kernels import int8_attend_decode as _iad
from repro_torch.kernels import int8_matmul as _imm
from repro_torch.kernels import paged_attend_decode as _pad
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


def rms_fake_quant(x, gamma, scale, zp, *, qmin: int = 0, qmax: int = 255,
                   eps: float = 1e-6):
    x2, lead = _rows(x)
    fn = _pick(x, _lnq.rms_fake_quant_plain, _lnq.rms_fake_quant_cuda)
    return _unrows(fn(x2, gamma, scale, zp, qmin=qmin, qmax=qmax, eps=eps),
                   lead)


def ln_quantize(x, gamma, beta, scale, zp, *, qmin: int = 0, qmax: int = 255,
                eps: float = 1e-6):
    x2, lead = _rows(x)
    fn = _pick(x, _lnq.ln_quantize_plain, _lnq.ln_quantize_cuda)
    return _unrows(fn(x2, gamma, beta, scale, zp, qmin=qmin, qmax=qmax,
                      eps=eps), lead)


def ln_fake_quant(x, gamma, beta, scale, zp, *, qmin: int = 0,
                  qmax: int = 255, eps: float = 1e-6):
    x2, lead = _rows(x)
    fn = _pick(x, _lnq.ln_fake_quant_plain, _lnq.ln_fake_quant_cuda)
    return _unrows(fn(x2, gamma, beta, scale, zp, qmin=qmin, qmax=qmax,
                      eps=eps), lead)


def peg_quantize(x, scales, zps, *, qmin: int = 0, qmax: int = 255):
    x2, lead = _rows(x)
    fn = _pick(x, _peg.peg_quantize_plain, _peg.peg_quantize_cuda)
    return _unrows(fn(x2, scales, zps, qmin=qmin, qmax=qmax), lead)


def peg_fake_quant(x, scales, zps, *, qmin: int = 0, qmax: int = 255):
    x2, lead = _rows(x)
    fn = _pick(x, _peg.peg_fake_quant_plain, _peg.peg_fake_quant_cuda)
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


def _zero_points(q_scale, q_zp, k_zp, v_zp):
    """Absent zero-points are zeros: (B, KV, G) for q, (B, KV) for k, v."""
    def zeros(shape):
        return torch.zeros(shape, dtype=torch.float32, device=q_scale.device)
    return (zeros(q_scale.shape) if q_zp is None else q_zp,
            zeros(q_scale.shape[:2]) if k_zp is None else k_zp,
            zeros(q_scale.shape[:2]) if v_zp is None else v_zp)


def _pad_cells(t, pad, value=0):
    """Pad axis 1 (the cell axis) of ``t`` by ``pad`` cells."""
    return torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad),
                                   value=value)


def int8_attend_decode(q_q, q_scale, k_q, k_scale, v_q, v_scale, k_pos,
                       q_pos, *, q_zp=None, k_zp=None, v_zp=None,
                       window=None, logit_softcap=None, sm_quant=None,
                       sm_qmin: int = 0, sm_qmax: int = 255, smo_quant=None,
                       smo_qmin: int = 0, smo_qmax: int = 255,
                       chunk: int = 256, kv_bits: int = 8, out_scale=None,
                       out_zp=None, qmin: int = -128, qmax: int = 127):
    """Decode attention over a dense int8 KV cache (K5). q_q (B, KV, G, hd)
    int8; q_scale (B, KV, G) f32 with the attention scale folded in; k_q /
    v_q (B, S, KV, hd) int8, or (B, S, KV, hd/2) split-half nibbles with
    ``kv_bits=4``; k_scale / v_scale (B, S, KV) f32; k_pos (B, S) (-1 =
    empty); q_pos (B,). ``sm_quant`` / ``smo_quant``: optional (2,)
    [scale, zp] of the softmax_in / softmax_out sites. Returns
    (B, KV, G, hd) f32, or with ``out_scale`` (and ``out_zp``, ``qmin``,
    ``qmax``: a per-tensor grid) its rows quantized for the output
    projection, (B, KV*G*hd) int8."""
    q_zp, k_zp, v_zp = _zero_points(q_scale, q_zp, k_zp, v_zp)
    s_len = k_pos.shape[1]
    pad = (-s_len) % min(chunk, s_len)
    if pad:
        k_q, v_q = _pad_cells(k_q, pad), _pad_cells(v_q, pad)
        k_scale, v_scale = _pad_cells(k_scale, pad), _pad_cells(v_scale, pad)
        k_pos = _pad_cells(k_pos, pad, value=-1)
    fn = _pick(q_q, _iad.int8_attend_decode_plain,
               _iad.int8_attend_decode_cuda)
    return fn(q_q, q_scale, q_zp, k_zp, v_zp, k_q, k_scale, v_q, v_scale,
              k_pos, q_pos, window=window, logit_softcap=logit_softcap,
              sm_quant=sm_quant, sm_qmin=sm_qmin, sm_qmax=sm_qmax,
              smo_quant=smo_quant, smo_qmin=smo_qmin, smo_qmax=smo_qmax,
              kv_bits=kv_bits, out_scale=out_scale, out_zp=out_zp, qmin=qmin,
              qmax=qmax)


def _lane_blocks(block_table, s_cap, block_size):
    """The table columns a layer of capacity ``s_cap`` can touch: a
    sliding-window layer needs only the first ceil(s_cap / bs), so its
    kernel never walks blocks that only global layers use."""
    return block_table[:, :-(-s_cap // block_size)]


def paged_attend_decode(q, k_arena, v_arena, block_table, q_pos, *,
                        s_cap: int, window=None, logit_softcap=None,
                        sm_quant=None, sm_qmin: int = 0, sm_qmax: int = 255,
                        smo_quant=None, smo_qmin: int = 0,
                        smo_qmax: int = 255, out_scale=None, out_zp=None,
                        qmin: int = -128, qmax: int = 127):
    """Decode attention over a paged f32/bf16 KV cache (K7). q (B, KV, G,
    hd) with the attention scale folded in; arenas (N, bs, KV, hd);
    block_table (B, nb) int32 (-1 = unmapped); q_pos (B,) (-1 = idle lane);
    ``s_cap`` is the layer's logical capacity. Returns (B, KV, G, hd) f32,
    or the (B, KV*G*hd) int8 emit with ``out_scale`` (as
    :func:`int8_attend_decode`)."""
    fn = _pick(q, _pad.paged_attend_decode_plain,
               _pad.paged_attend_decode_cuda)
    return fn(q, k_arena, v_arena,
              _lane_blocks(block_table, s_cap, k_arena.shape[1]), q_pos,
              s_cap=s_cap, window=window, logit_softcap=logit_softcap,
              sm_quant=sm_quant, sm_qmin=sm_qmin, sm_qmax=sm_qmax,
              smo_quant=smo_quant, smo_qmin=smo_qmin, smo_qmax=smo_qmax,
              out_scale=out_scale, out_zp=out_zp, qmin=qmin, qmax=qmax)


def paged_int8_attend_decode(q_q, q_scale, k_arena, k_scale, v_arena,
                             v_scale, block_table, q_pos, *, s_cap: int,
                             q_zp=None, k_zp=None, v_zp=None, window=None,
                             logit_softcap=None, sm_quant=None,
                             sm_qmin: int = 0, sm_qmax: int = 255,
                             smo_quant=None, smo_qmin: int = 0,
                             smo_qmax: int = 255, kv_bits: int = 8,
                             out_scale=None, out_zp=None, qmin: int = -128,
                             qmax: int = 127):
    """Decode attention over a paged int8 KV cache (K6), the paged twin of
    :func:`int8_attend_decode`: arenas (N, bs, KV, hd) int8, or (N, bs,
    KV, hd/2) nibbles with ``kv_bits=4``, with per-cell scales (N, bs, KV)
    f32. Returns (B, KV, G, hd) f32, or the (B, KV*G*hd) int8 emit with
    ``out_scale``."""
    q_zp, k_zp, v_zp = _zero_points(q_scale, q_zp, k_zp, v_zp)
    fn = _pick(q_q, _pad.paged_int8_attend_decode_plain,
               _pad.paged_int8_attend_decode_cuda)
    return fn(q_q, q_scale, q_zp, k_zp, v_zp, k_arena, k_scale, v_arena,
              v_scale, _lane_blocks(block_table, s_cap, k_arena.shape[1]),
              q_pos, s_cap=s_cap, window=window, logit_softcap=logit_softcap,
              sm_quant=sm_quant, sm_qmin=sm_qmin, sm_qmax=sm_qmax,
              smo_quant=smo_quant, smo_qmin=smo_qmin, smo_qmax=smo_qmax,
              kv_bits=kv_bits, out_scale=out_scale, out_zp=out_zp, qmin=qmin,
              qmax=qmax)
