"""Dequantize-then-compute oracles for the ported kernels (PyTorch twins of
``repro.kernels.ref``): independent of the kernels' integer arithmetic, so
tests can hold both the plain versions and the kernels against them."""
from __future__ import annotations

import torch

from repro_torch.kernels._args import expand_groups
# the norm and group quantizers' plain versions are their oracles (the same
# arithmetic as repro.kernels.ref's *_quantize_ref / *_fake_quant_ref)
from repro_torch.kernels.fused_ln_quant import (  # noqa: F401
    ln_fake_quant_plain as ln_fake_quant_ref,
    ln_quantize_plain as ln_quantize_ref,
    rms_fake_quant_plain as rms_fake_quant_ref,
    rms_quantize_plain as rms_quantize_ref)
from repro_torch.kernels.int8_matmul import epilogue
from repro_torch.kernels.nibble import unpack_nibbles
from repro_torch.kernels.peg_quant import (  # noqa: F401
    peg_fake_quant_plain as peg_fake_quant_ref,
    peg_quantize_plain as peg_quantize_ref)


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


def site_fake_quant(x, sq, qmin, qmax):
    """Per-tensor fake-quant on the grid ``sq`` = [scale, zero_point]."""
    s, z = sq[0], sq[1]
    return (torch.clamp(torch.round(x / s) + z, qmin, qmax) - z) * s


def _softmax_attend(s, valid, v, *, logit_softcap, sm_quant, sm_qmin,
                    sm_qmax, smo_quant, smo_qmin, smo_qmax):
    """softcap -> softmax_in -> mask -> softmax -> softmax_out (not
    renormalised) -> p @ v. s (B, KV, G, n); valid (B, n); v (B, n, KV, hd)
    f32. Returns (B, KV, G, hd) f32."""
    if logit_softcap is not None:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    if sm_quant is not None:
        s = site_fake_quant(s, sm_quant, sm_qmin, sm_qmax)
    s = torch.where(valid[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    if smo_quant is not None:
        p = site_fake_quant(p, smo_quant, smo_qmin, smo_qmax)
    return torch.einsum("bkgs,bskd->bkgd", p, v)


def decode_valid(k_pos, q_pos, window):
    """(B, S) key mask: written, causal and inside the window."""
    kp, qp = k_pos, q_pos.reshape(-1, 1)
    valid = (kp >= 0) & (kp <= qp)
    if window is not None:
        valid = valid & (kp > qp - window)
    return valid


def int8_attend_decode_ref(q_q, q_scale, k_q, k_scale, v_q, v_scale, k_pos,
                           q_pos, *, q_zp=None, k_zp=None, v_zp=None,
                           window=None, logit_softcap=None, sm_quant=None,
                           sm_qmin=0, sm_qmax=255, smo_quant=None,
                           smo_qmin=0, smo_qmax=255, kv_bits=8):
    """Dequantize-then-attend oracle for the int8 KV decode kernel (K5):
    q_q (B, KV, G, hd) int8, q_scale / q_zp (B, KV, G), k_zp / v_zp
    (B, KV), k_q / v_q (B, S, KV, hd) int8, k_scale / v_scale (B, S, KV),
    k_pos (B, S), q_pos (B,). ``kv_bits=4``: k_q / v_q are (B, S, KV,
    hd/2) split-half nibbles, unpacked first. Returns (B, KV, G, hd) f32."""
    if kv_bits == 4:
        hd = q_q.shape[-1]
        k_q, v_q = unpack_nibbles(k_q, hd), unpack_nibbles(v_q, hd)
    qh = q_q.float()
    if q_zp is not None:
        qh = qh - q_zp.float()[..., None]
    qh = qh * q_scale.float()[..., None]
    kh, vh = k_q.float(), v_q.float()
    if k_zp is not None:
        kh = kh - k_zp.float()[:, None, :, None]
    if v_zp is not None:
        vh = vh - v_zp.float()[:, None, :, None]
    kh = kh * k_scale.float()[..., None]
    vh = vh * v_scale.float()[..., None]
    s = torch.einsum("bkgd,bskd->bkgs", qh, kh)
    return _softmax_attend(
        s, decode_valid(k_pos, q_pos, window), vh, logit_softcap=logit_softcap,
        sm_quant=sm_quant, sm_qmin=sm_qmin, sm_qmax=sm_qmax,
        smo_quant=smo_quant, smo_qmin=smo_qmin, smo_qmax=smo_qmax)


def paged_positions_ref(block_table, q_pos, *, s_cap, block_size,
                        cell_lo=0, cells=None):
    """Derived key positions (B, nb*cells) of a block-paged lane: logical
    cell L holds position ``q_pos - ((q_pos - L) mod s_cap)`` (floor modulo)
    when that is >= 0, L < s_cap and its block is mapped; everything else
    -1. ``cells`` (default ``block_size``) of each block, from ``cell_lo``
    on: a rank's in-block range when the arena's cell dim is cut over
    tensor-parallel ranks (cell c of table column t is L = t * block_size +
    cell_lo + c)."""
    nb = block_table.shape[1]
    cells = block_size if cells is None else cells
    L = (torch.arange(nb, dtype=torch.int32,
                      device=block_table.device)[:, None] * block_size
         + cell_lo + torch.arange(cells, dtype=torch.int32,
                                  device=block_table.device)[None, :])
    L = L.reshape(1, -1)
    qp = q_pos.to(torch.int32).reshape(-1, 1)
    p = qp - torch.remainder(qp - L, s_cap)
    mapped = torch.repeat_interleave(block_table >= 0, cells, dim=1)
    valid = (L < s_cap) & (p >= 0) & mapped
    return torch.where(valid, p, torch.full_like(p, -1))


def paged_gather_ref(arena, block_table):
    """(N, bs, ...) arena + (B, nb) block table -> (B, nb*bs, ...) per-lane
    view; unmapped (-1) blocks read block 0 (callers mask them)."""
    phys = torch.clamp(block_table.long(), 0, arena.shape[0] - 1)
    g = arena[phys]                                    # (B, nb, bs, ...)
    return g.reshape(g.shape[0], -1, *arena.shape[2:])


def paged_attend_decode_ref(q, k_arena, v_arena, block_table, q_pos, *,
                            s_cap, window=None, logit_softcap=None,
                            sm_quant=None, sm_qmin=0, sm_qmax=255,
                            smo_quant=None, smo_qmin=0, smo_qmax=255):
    """Gather-then-attend oracle for the paged f32/bf16 decode kernel (K7):
    q (B, KV, G, hd) with the attention scale folded in."""
    bs = k_arena.shape[1]
    k = paged_gather_ref(k_arena, block_table).float()
    v = paged_gather_ref(v_arena, block_table).float()
    kp = paged_positions_ref(block_table, q_pos, s_cap=s_cap, block_size=bs)
    s = torch.einsum("bkgd,bskd->bkgs", q.float(), k)
    return _softmax_attend(
        s, decode_valid(kp, q_pos, window), v, logit_softcap=logit_softcap,
        sm_quant=sm_quant, sm_qmin=sm_qmin, sm_qmax=sm_qmax,
        smo_quant=smo_quant, smo_qmin=smo_qmin, smo_qmax=smo_qmax)


def paged_int8_attend_decode_ref(q_q, q_scale, k_arena, k_scale, v_arena,
                                 v_scale, block_table, q_pos, *, s_cap,
                                 q_zp=None, k_zp=None, v_zp=None,
                                 window=None, logit_softcap=None,
                                 sm_quant=None, sm_qmin=0, sm_qmax=255,
                                 smo_quant=None, smo_qmin=0, smo_qmax=255,
                                 kv_bits=8):
    """Gather-then-dequantize oracle for the paged int8 decode kernel (K6):
    :func:`int8_attend_decode_ref` over the per-lane view and its derived
    positions (the gather does not care whether the arenas are packed)."""
    bs = k_arena.shape[1]
    kp = paged_positions_ref(block_table, q_pos, s_cap=s_cap, block_size=bs)
    return int8_attend_decode_ref(
        q_q, q_scale, paged_gather_ref(k_arena, block_table),
        paged_gather_ref(k_scale, block_table),
        paged_gather_ref(v_arena, block_table),
        paged_gather_ref(v_scale, block_table), kp, q_pos, q_zp=q_zp,
        k_zp=k_zp, v_zp=v_zp, window=window, logit_softcap=logit_softcap,
        sm_quant=sm_quant, sm_qmin=sm_qmin, sm_qmax=sm_qmax,
        smo_quant=smo_quant, smo_qmin=smo_qmin, smo_qmax=smo_qmax,
        kv_bits=kv_bits)
