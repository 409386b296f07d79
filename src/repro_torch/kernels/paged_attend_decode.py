"""One decode step of attention against a block-paged KV cache (K6, K7).

The paged cache stores each layer's K/V as one arena of N blocks of ``bs``
token cells (no batch axis); a (B, nb) int32 block table (-1 = unmapped)
says which physical block backs each logical block of each lane. Cell L of
lane b lives in block ``table[b, L // bs]`` (clamped at 0, masked when
unmapped) and its position is derived, not read:
``p = q_pos - ((q_pos - L) mod s_cap)`` with a floor modulo, valid iff
``L < s_cap``, ``p >= 0``, the block is mapped (and ``p > q_pos - window``),
so stale cells of a reused block are never read as valid.

* ``paged_int8_attend_decode_*`` (K6; port of
  ``repro.kernels.paged_attend_decode.paged_int8_attend_decode``,
  ``kv_bits`` 8 and 4): int8 or nibble-packed ``(N, bs, KV, hd/2)`` arenas
  with per-cell scales, the math of K5 (``launches`` / ``launches_kv4``),
  and K5's optional int8 emit for the output projection (``out_scale``;
  ``launches_emit``).
* ``paged_attend_decode_*`` (K7; port of ``...paged_attend_decode``): f32 or
  bf16 arenas, queries f32 with the attention scale folded in
  (``launches``), and the same optional int8 emit (``launches_emit``).

``*_cuda`` launch ``csrc/paged_attend_decode.cu``; ``*_plain`` gather each
lane's blocks into a dense view and run the plain softmax of
``int8_attend_decode``. Both kernels run the split-KV body they share with
K5 (``csrc/split_attend.cuh``; int8 or float payloads): it splits each
lane's blocks across thread blocks (:func:`plan_kv_splits`) and merges the
splits' partial softmax states in split order, in a per-device workspace
that it leaves clean; with ``softmax_out`` it makes two launches from one
C call.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _args, _build
from repro_torch.kernels import int8_attend_decode as _iad
from repro_torch.kernels.ref import (decode_valid, paged_gather_ref,
                                     paged_positions_ref)


def paged_int8_attend_decode_plain(q_q, q_scale, q_zp, k_zp, v_zp, k_arena,
                                   k_scale, v_arena, v_scale, block_table,
                                   q_pos, *, s_cap, window, logit_softcap,
                                   sm_quant, sm_qmin, sm_qmax, smo_quant,
                                   smo_qmin, smo_qmax, kv_bits=8,
                                   out_scale=None, out_zp=None, qmin=-128,
                                   qmax=127) -> torch.Tensor:
    kp = paged_positions_ref(block_table, q_pos, s_cap=s_cap,
                             block_size=k_arena.shape[1])
    return _iad.int8_attend_decode_plain(
        q_q, q_scale, q_zp, k_zp, v_zp,
        paged_gather_ref(k_arena, block_table),
        paged_gather_ref(k_scale, block_table),
        paged_gather_ref(v_arena, block_table),
        paged_gather_ref(v_scale, block_table), kp, q_pos, window=window,
        logit_softcap=logit_softcap, sm_quant=sm_quant, sm_qmin=sm_qmin,
        sm_qmax=sm_qmax, smo_quant=smo_quant, smo_qmin=smo_qmin,
        smo_qmax=smo_qmax, kv_bits=kv_bits, out_scale=out_scale,
        out_zp=out_zp, qmin=qmin, qmax=qmax)


def paged_attend_decode_plain(q, k_arena, v_arena, block_table, q_pos, *,
                              s_cap, window, logit_softcap, sm_quant,
                              sm_qmin, sm_qmax, smo_quant, smo_qmin,
                              smo_qmax, out_scale=None, out_zp=None,
                              qmin=-128, qmax=127) -> torch.Tensor:
    kp = paged_positions_ref(block_table, q_pos, s_cap=s_cap,
                             block_size=k_arena.shape[1])
    k = paged_gather_ref(k_arena, block_table).float()
    s = torch.einsum("bkgd,bskd->bkgs", q.float(), k)
    out = _iad.softmax_attend(
        s, decode_valid(kp, q_pos, window),
        paged_gather_ref(v_arena, block_table), logit_softcap=logit_softcap,
        sm_quant=sm_quant, sm_qmin=sm_qmin, sm_qmax=sm_qmax,
        smo_quant=smo_quant, smo_qmin=smo_qmin, smo_qmax=smo_qmax)
    return _iad.emit_plain(out, out_scale, out_zp, qmin, qmax)


SMS = _iad.SMS
MAX_SPLIT_CELLS = _iad.MAX_SPLIT_CELLS
MAX_SPLITS = _iad.MAX_SPLITS
MAX_SPLIT_BLOCKS = 256   # the kernel's table entries a split holds


def plan_kv_splits(batch, kv, nb, bs):
    """(splits, blocks per split) of K6 and K7 for ``batch`` lanes of
    ``kv`` heads over ``nb`` paged blocks of ``bs`` cells: enough splits
    for the grid to reach one wave (``SMS`` blocks) and for no split to
    hold more than 128 cells, at most one per paged block and at most 32;
    split j owns the blocks [j * bps, min(nb, (j + 1) * bps)), none of
    them empty."""
    want = max(-(-SMS // max(1, batch * kv)), -(-nb * bs // MAX_SPLIT_CELLS))
    bps = max(1, nb // max(1, min(want, nb)), -(-nb // MAX_SPLITS))
    if bps > MAX_SPLIT_BLOCKS:
        raise ValueError(f"paged attention decode: {nb} blocks exceed the "
                         f"kernel's {MAX_SPLITS} x {MAX_SPLIT_BLOCKS}")
    return -(-nb // bps), bps


def kv_split_blocks(nb, splits, bps):
    """The [first, end) paged blocks of each split, as the kernel cuts
    them."""
    return [(j * bps, min(nb, (j + 1) * bps)) for j in range(splits)]


def _table(block_table, b, bs, s_cap):
    nb = block_table.shape[1]
    if block_table.shape[0] != b or nb * bs < s_cap:
        raise ValueError(f"block table {tuple(block_table.shape)} does not "
                         f"cover {b} lanes x s_cap={s_cap} at bs={bs}")
    return block_table.to(torch.int32).contiguous(), nb


def paged_int8_attend_decode_cuda(q_q, q_scale, q_zp, k_zp, v_zp, k_arena,
                                  k_scale, v_arena, v_scale, block_table,
                                  q_pos, *, s_cap, window, logit_softcap,
                                  sm_quant, sm_qmin, sm_qmax, smo_quant,
                                  smo_qmin, smo_qmax, kv_bits=8,
                                  out_scale=None, out_zp=None, qmin=-128,
                                  qmax=127) -> torch.Tensor:
    b, kv, g, hd = _iad.check_query(q_q, torch.int8)
    _args.on_cuda(q_q, k_arena, v_arena, block_table, q_pos)
    n, bs = k_arena.shape[:2]
    q_q = q_q.contiguous()
    shape = _iad.payload_shape((n, bs), kv, hd, kv_bits)
    k_arena = _iad.check_int8(k_arena, shape, "k_arena")
    v_arena = _iad.check_int8(v_arena, shape, "v_arena")
    q_scale = _iad.f32_like(q_scale, (b, kv, g), "q_scale")
    q_zp = _iad.f32_like(q_zp, (b, kv, g), "q_zp")
    k_zp = _iad.f32_like(k_zp, (b, kv), "k_zp")
    v_zp = _iad.f32_like(v_zp, (b, kv), "v_zp")
    k_scale = _iad.f32_like(k_scale, (n, bs, kv), "k_scale")
    v_scale = _iad.f32_like(v_scale, (n, bs, kv), "v_scale")
    table, nb = _table(block_table, b, bs, s_cap)
    q_pos = _iad.i32(q_pos.reshape(-1), (b,), "q_pos")
    sm, smo = _iad.site_args(sm_quant, smo_quant, q_q.device)
    out, s_o, z_o = _iad.output(b, kv, g, hd, out_scale, out_zp, q_q.device)
    emit = s_o is not None
    splits, bps = plan_kv_splits(b, kv, nb, bs)
    stream = _args.stream()
    ws, counters = _iad.split_scratch(q_q.device, stream,
                                      b * kv * splits * g * (hd + 2), b * kv)
    p = _args.ptr
    _build.check(_build.lib("paged_attend_decode").paged_int8_attend_decode(
        p(q_q), p(q_scale), p(q_zp), p(k_zp), p(v_zp), p(k_arena),
        p(k_scale), p(v_arena), p(v_scale), p(table), p(q_pos), p(sm), p(smo),
        p(None if emit else out), p(out if emit else None), p(s_o), p(z_o),
        qmin, qmax, b, kv, g, hd, nb, bs, s_cap, _iad.window_arg(window),
        _iad.softcap_arg(logit_softcap), sm_qmin, sm_qmax, smo_qmin,
        smo_qmax, kv_bits, splits, bps, p(ws), p(counters), stream),
        "paged_int8_attend_decode")
    _iad.count_launch(paged_int8_attend_decode_cuda, kv_bits, emit)
    return out


def paged_attend_decode_cuda(q, k_arena, v_arena, block_table, q_pos, *,
                             s_cap, window, logit_softcap, sm_quant, sm_qmin,
                             sm_qmax, smo_quant, smo_qmin, smo_qmax,
                             out_scale=None, out_zp=None, qmin=-128,
                             qmax=127) -> torch.Tensor:
    b, kv, g, hd = _iad.check_query(q.float(), torch.float32)
    _args.on_cuda(q, k_arena, v_arena, block_table, q_pos)
    n, bs = k_arena.shape[:2]
    if k_arena.dtype not in (torch.float32, torch.bfloat16) or \
            v_arena.dtype != k_arena.dtype or \
            tuple(k_arena.shape) != (n, bs, kv, hd) or \
            tuple(v_arena.shape) != (n, bs, kv, hd):
        raise ValueError(f"paged_attend_decode: arenas must be "
                         f"{(n, bs, kv, hd)} f32 or bf16, got "
                         f"{tuple(k_arena.shape)} {k_arena.dtype} / "
                         f"{tuple(v_arena.shape)} {v_arena.dtype}")
    q = q.float().contiguous()
    k_arena, v_arena = k_arena.contiguous(), v_arena.contiguous()
    if k_arena.data_ptr() % 4 or v_arena.data_ptr() % 4:
        raise ValueError("paged_attend_decode: arenas must be 4-byte "
                         "aligned (the kernel copies 4 or 16 bytes at a "
                         "time)")
    table, nb = _table(block_table, b, bs, s_cap)
    q_pos = _iad.i32(q_pos.reshape(-1), (b,), "q_pos")
    sm, smo = _iad.site_args(sm_quant, smo_quant, q.device)
    out, s_o, z_o = _iad.output(b, kv, g, hd, out_scale, out_zp, q.device)
    emit = s_o is not None
    splits, bps = plan_kv_splits(b, kv, nb, bs)
    stream = _args.stream()
    ws, counters = _iad.split_scratch(q.device, stream,
                                      b * kv * splits * g * (hd + 2), b * kv)
    p = _args.ptr
    _build.check(_build.lib("paged_attend_decode").paged_attend_decode(
        p(q), p(k_arena), p(v_arena), int(k_arena.dtype == torch.bfloat16),
        p(table), p(q_pos), p(sm), p(smo), p(None if emit else out),
        p(out if emit else None), p(s_o), p(z_o), qmin, qmax, b, kv, g, hd,
        nb, bs, s_cap, _iad.window_arg(window),
        _iad.softcap_arg(logit_softcap), sm_qmin, sm_qmax, smo_qmin,
        smo_qmax, splits, bps, p(ws), p(counters), stream),
        "paged_attend_decode")
    paged_attend_decode_cuda.launches += 1
    if emit:
        paged_attend_decode_cuda.launches_emit += 1
    return out


paged_int8_attend_decode_cuda.launches = 0
paged_int8_attend_decode_cuda.launches_kv4 = 0
paged_int8_attend_decode_cuda.launches_emit = 0
paged_attend_decode_cuda.launches = 0
paged_attend_decode_cuda.launches_emit = 0
