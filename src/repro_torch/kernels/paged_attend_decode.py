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

Partial mode (``*_partials_*``; ``int8_attend_decode`` says what the rows
hold and how ``merge_partials`` merges them): a tensor-parallel rank's
arena holds the in-block cells ``[cell_lo, cell_lo + bs)`` of blocks of
``block_size`` logical cells (the arena's cell dim cut over the ranks).
Cell c of table column t is the lane's logical cell ``t * block_size +
cell_lo + c``; its position is derived from that index as above.
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
    """The contiguous int32 table and its width; ``bs`` the logical cells a
    block."""
    nb = block_table.shape[1]
    if block_table.shape[0] != b or nb * bs < s_cap:
        raise ValueError(f"block table {tuple(block_table.shape)} does not "
                         f"cover {b} lanes x s_cap={s_cap} at bs={bs}")
    return block_table.to(torch.int32).contiguous(), nb


def _quant_operands(q_q, q_scale, q_zp, k_zp, v_zp, k_arena, k_scale,
                    v_arena, v_scale, block_table, q_pos, s_cap, block_size,
                    kv_bits):
    """K6's operands checked and contiguous (the arenas' cells a block and
    the logical ``block_size`` may differ: a rank's in-block range), and
    (B, KV, G, hd, table columns, the arenas' cells a block)."""
    b, kv, g, hd = _iad.check_query(q_q, torch.int8)
    _args.on_cuda(q_q, k_arena, v_arena, block_table, q_pos)
    n, cells = k_arena.shape[:2]
    shape = _iad.payload_shape((n, cells), kv, hd, kv_bits)
    table, nb = _table(block_table, b, block_size, s_cap)
    return (q_q.contiguous(), _iad.f32_like(q_scale, (b, kv, g), "q_scale"),
            _iad.f32_like(q_zp, (b, kv, g), "q_zp"),
            _iad.f32_like(k_zp, (b, kv), "k_zp"),
            _iad.f32_like(v_zp, (b, kv), "v_zp"),
            _iad.check_int8(k_arena, shape, "k_arena"),
            _iad.f32_like(k_scale, (n, cells, kv), "k_scale"),
            _iad.check_int8(v_arena, shape, "v_arena"),
            _iad.f32_like(v_scale, (n, cells, kv), "v_scale"), table,
            _iad.i32(q_pos.reshape(-1), (b,), "q_pos")), \
        (b, kv, g, hd, nb, cells)


def _float_operands(q, k_arena, v_arena, block_table, q_pos, s_cap,
                    block_size):
    """K7's operands checked and contiguous, and the dims of
    :func:`_quant_operands`."""
    b, kv, g, hd = _iad.check_query(q.float(), torch.float32)
    _args.on_cuda(q, k_arena, v_arena, block_table, q_pos)
    n, cells = k_arena.shape[:2]
    if k_arena.dtype not in (torch.float32, torch.bfloat16) or \
            v_arena.dtype != k_arena.dtype or \
            tuple(k_arena.shape) != (n, cells, kv, hd) or \
            tuple(v_arena.shape) != (n, cells, kv, hd):
        raise ValueError(f"paged_attend_decode: arenas must be "
                         f"{(n, cells, kv, hd)} f32 or bf16, got "
                         f"{tuple(k_arena.shape)} {k_arena.dtype} / "
                         f"{tuple(v_arena.shape)} {v_arena.dtype}")
    k_arena, v_arena = k_arena.contiguous(), v_arena.contiguous()
    if k_arena.data_ptr() % 4 or v_arena.data_ptr() % 4:
        raise ValueError("paged_attend_decode: arenas must be 4-byte "
                         "aligned (the kernel copies 4 or 16 bytes at a "
                         "time)")
    table, nb = _table(block_table, b, block_size, s_cap)
    return (q.float().contiguous(), k_arena, v_arena, table,
            _iad.i32(q_pos.reshape(-1), (b,), "q_pos")), \
        (b, kv, g, hd, nb, cells)


def _paged_launch(entry, operands, dims, sites, out, tail, *, s_cap,
                  block_size, cell_lo=0, mode=0, part=None, ml_in=None):
    """Launch K6 (``entry`` "paged_int8_attend_decode", ``tail`` (kv_bits,))
    or K7 ("paged_attend_decode", ``tail`` ()) on its operands; ``sites``
    and ``out`` as ``int8_attend_decode._dense_launch``'s. K7's operands
    carry the arenas' dtype flag after them."""
    b, kv, g, hd, nb, cells = dims
    window, softcap, sm, smo, sm_qmin, sm_qmax, smo_qmin, smo_qmax = sites
    f32_out, out_q, s_o, z_o, qmin, qmax = out
    splits, bps = plan_kv_splits(b, kv, nb, cells)
    stream = _args.stream()
    ws = counters = None
    if part is None:
        ws, counters = _iad.split_scratch(operands[0].device, stream,
                                          b * kv * splits * g * (hd + 2),
                                          b * kv)
    p = _args.ptr
    head = [p(x) for x in operands]
    if entry == "paged_attend_decode":      # q, k, v, the bf16 flag, ...
        head.insert(3, int(operands[1].dtype == torch.bfloat16))
    _build.check(getattr(_build.lib("paged_attend_decode"), entry)(
        *head, p(sm), p(smo), p(f32_out), p(out_q), p(s_o), p(z_o), qmin,
        qmax, b, kv, g, hd, nb, cells, s_cap, _iad.window_arg(window),
        _iad.softcap_arg(softcap), sm_qmin, sm_qmax, smo_qmin, smo_qmax,
        *tail, splits, bps, p(ws), p(counters), mode, p(part), p(ml_in),
        block_size, cell_lo, stream),
        entry + (" partials" if part is not None else ""))


def _whole_out(b, kv, g, hd, out_scale, out_zp, qmin, qmax, dev):
    out, s_o, z_o = _iad.output(b, kv, g, hd, out_scale, out_zp, dev)
    emit = s_o is not None
    return out, emit, (None if emit else out, out if emit else None, s_o,
                       z_o, qmin, qmax)


def paged_int8_attend_decode_cuda(q_q, q_scale, q_zp, k_zp, v_zp, k_arena,
                                  k_scale, v_arena, v_scale, block_table,
                                  q_pos, *, s_cap, window, logit_softcap,
                                  sm_quant, sm_qmin, sm_qmax, smo_quant,
                                  smo_qmin, smo_qmax, kv_bits=8,
                                  out_scale=None, out_zp=None, qmin=-128,
                                  qmax=127) -> torch.Tensor:
    bs = k_arena.shape[1]
    operands, dims = _quant_operands(q_q, q_scale, q_zp, k_zp, v_zp, k_arena,
                                     k_scale, v_arena, v_scale, block_table,
                                     q_pos, s_cap, bs, kv_bits)
    dev = operands[0].device
    sm, smo = _iad.site_args(sm_quant, smo_quant, dev)
    out, emit, dest = _whole_out(*dims[:4], out_scale, out_zp, qmin, qmax,
                                 dev)
    _paged_launch("paged_int8_attend_decode", operands, dims,
                  (window, logit_softcap, sm, smo, sm_qmin, sm_qmax,
                   smo_qmin, smo_qmax), dest, (kv_bits,), s_cap=s_cap,
                  block_size=bs)
    _iad.count_launch(paged_int8_attend_decode_cuda, kv_bits, emit)
    return out


def paged_attend_decode_cuda(q, k_arena, v_arena, block_table, q_pos, *,
                             s_cap, window, logit_softcap, sm_quant, sm_qmin,
                             sm_qmax, smo_quant, smo_qmin, smo_qmax,
                             out_scale=None, out_zp=None, qmin=-128,
                             qmax=127) -> torch.Tensor:
    bs = k_arena.shape[1]
    operands, dims = _float_operands(q, k_arena, v_arena, block_table, q_pos,
                                     s_cap, bs)
    dev = operands[0].device
    sm, smo = _iad.site_args(sm_quant, smo_quant, dev)
    out, emit, dest = _whole_out(*dims[:4], out_scale, out_zp, qmin, qmax,
                                 dev)
    _paged_launch("paged_attend_decode", operands, dims,
                  (window, logit_softcap, sm, smo, sm_qmin, sm_qmax,
                   smo_qmin, smo_qmax), dest, (), s_cap=s_cap, block_size=bs)
    paged_attend_decode_cuda.launches += 1
    if emit:
        paged_attend_decode_cuda.launches_emit += 1
    return out


paged_int8_attend_decode_cuda.launches = 0
paged_int8_attend_decode_cuda.launches_kv4 = 0
paged_int8_attend_decode_cuda.launches_emit = 0
paged_attend_decode_cuda.launches = 0
paged_attend_decode_cuda.launches_emit = 0


# -- partial mode: a rank's in-block cells, merged across ranks -------------

def _window(arena, block_size, cell_lo):
    """(the arena's cells a block, the logical block size): the rank holds
    [cell_lo, cell_lo + cells) of every block."""
    cells = arena.shape[1]
    block_size = cells if block_size is None else block_size
    if cell_lo < 0 or cell_lo + cells > block_size:
        raise ValueError(f"paged attention partials: cells [{cell_lo}, "
                         f"{cell_lo + cells}) do not fit a block of "
                         f"{block_size}")
    return cells, block_size


def _split_cells(b, kv, nb, cells):
    """The [first, end) of each split in the rank's cells of a lane."""
    return [(lo * cells, hi * cells)
            for lo, hi in kv_split_blocks(nb, *plan_kv_splits(b, kv, nb,
                                                              cells))]


def paged_int8_attend_decode_partials_plain(
        q_q, q_scale, q_zp, k_zp, v_zp, k_arena, k_scale, v_arena, v_scale,
        block_table, q_pos, *, s_cap, block_size=None, cell_lo=0, mode,
        stats=None, window, logit_softcap, sm_quant, sm_qmin, sm_qmax,
        smo_quant, smo_qmin, smo_qmax, kv_bits=8):
    """K6's partial rows over the rank's cells of each block, split as the
    kernel splits them (:func:`plan_kv_splits` over the rank's cells)."""
    cells, block_size = _window(k_arena, block_size, cell_lo)
    b, kv = q_q.shape[:2]
    kp = paged_positions_ref(block_table, q_pos, s_cap=s_cap,
                             block_size=block_size, cell_lo=cell_lo,
                             cells=cells)
    k_q, v_q = _iad.kv_values(paged_gather_ref(k_arena, block_table),
                              paged_gather_ref(v_arena, block_table),
                              q_q.shape[-1], kv_bits)
    s = _iad.int8_logits(q_q, q_scale, q_zp, k_zp, k_q,
                         paged_gather_ref(k_scale, block_table))
    return _iad.partials_plain(
        s, decode_valid(kp, q_pos, window), v_q,
        paged_gather_ref(v_scale, block_table), v_zp,
        _split_cells(b, kv, block_table.shape[1], cells), mode=mode,
        stats=stats, logit_softcap=logit_softcap, sm_quant=sm_quant,
        sm_qmin=sm_qmin, sm_qmax=sm_qmax, smo_quant=smo_quant,
        smo_qmin=smo_qmin, smo_qmax=smo_qmax)


def paged_attend_decode_partials_plain(q, k_arena, v_arena, block_table,
                                       q_pos, *, s_cap, block_size=None,
                                       cell_lo=0, mode, stats=None, window,
                                       logit_softcap, sm_quant, sm_qmin,
                                       sm_qmax, smo_quant, smo_qmin,
                                       smo_qmax):
    """K7's partial rows over the rank's cells of each block."""
    cells, block_size = _window(k_arena, block_size, cell_lo)
    b, kv = q.shape[:2]
    kp = paged_positions_ref(block_table, q_pos, s_cap=s_cap,
                             block_size=block_size, cell_lo=cell_lo,
                             cells=cells)
    k = paged_gather_ref(k_arena, block_table).float()
    s = torch.einsum("bkgd,bskd->bkgs", q.float(), k)
    return _iad.partials_plain(
        s, decode_valid(kp, q_pos, window),
        paged_gather_ref(v_arena, block_table), None, None,
        _split_cells(b, kv, block_table.shape[1], cells), mode=mode,
        stats=stats, logit_softcap=logit_softcap, sm_quant=sm_quant,
        sm_qmin=sm_qmin, sm_qmax=sm_qmax, smo_quant=smo_quant,
        smo_qmin=smo_qmin, smo_qmax=smo_qmax)


def paged_int8_attend_decode_partials_cuda(
        q_q, q_scale, q_zp, k_zp, v_zp, k_arena, k_scale, v_arena, v_scale,
        block_table, q_pos, *, s_cap, block_size=None, cell_lo=0, mode,
        stats=None, window, logit_softcap, sm_quant, sm_qmin, sm_qmax,
        smo_quant, smo_qmin, smo_qmax, kv_bits=8):
    _, block_size = _window(k_arena, block_size, cell_lo)
    operands, dims = _quant_operands(q_q, q_scale, q_zp, k_zp, v_zp, k_arena,
                                     k_scale, v_arena, v_scale, block_table,
                                     q_pos, s_cap, block_size, kv_bits)
    part = _partials_launch("paged_int8_attend_decode", operands, dims,
                            (kv_bits,), mode, stats, window, logit_softcap,
                            sm_quant, sm_qmin, sm_qmax, smo_quant, smo_qmin,
                            smo_qmax, s_cap, block_size, cell_lo)
    _iad.count_launch(paged_int8_attend_decode_partials_cuda, kv_bits)
    return part


def paged_attend_decode_partials_cuda(q, k_arena, v_arena, block_table,
                                      q_pos, *, s_cap, block_size=None,
                                      cell_lo=0, mode, stats=None, window,
                                      logit_softcap, sm_quant, sm_qmin,
                                      sm_qmax, smo_quant, smo_qmin,
                                      smo_qmax):
    _, block_size = _window(k_arena, block_size, cell_lo)
    operands, dims = _float_operands(q, k_arena, v_arena, block_table, q_pos,
                                     s_cap, block_size)
    part = _partials_launch("paged_attend_decode", operands, dims, (), mode,
                            stats, window, logit_softcap, sm_quant, sm_qmin,
                            sm_qmax, smo_quant, smo_qmin, smo_qmax, s_cap,
                            block_size, cell_lo)
    paged_attend_decode_partials_cuda.launches += 1
    return part


def _partials_launch(entry, operands, dims, tail, mode, stats, window,
                     softcap, sm_quant, sm_qmin, sm_qmax, smo_quant,
                     smo_qmin, smo_qmax, s_cap, block_size, cell_lo):
    """K6's or K7's partial rows of this rank's cells (see
    :func:`_paged_launch`)."""
    b, kv, g, hd, nb, cells = dims
    _iad.check_partial(mode, stats, smo_quant, (b, kv, g))
    dev = operands[0].device
    sm, smo = _iad.site_args(sm_quant, smo_quant, dev)
    part = _iad.partial_output(b, kv, plan_kv_splits(b, kv, nb, cells)[0],
                               g, hd, mode, dev)
    _paged_launch(entry, operands, dims, (window, softcap, sm, smo, sm_qmin,
                                          sm_qmax, smo_qmin, smo_qmax),
                  (None, None, None, None, -128, 127), tail, s_cap=s_cap,
                  block_size=block_size, cell_lo=cell_lo,
                  mode=_iad.PARTIAL_MODES[mode], part=part,
                  ml_in=_iad.stats_arg(stats, (b, kv, g)))
    return part


paged_int8_attend_decode_partials_cuda.launches = 0
paged_int8_attend_decode_partials_cuda.launches_kv4 = 0
paged_attend_decode_partials_cuda.launches = 0
