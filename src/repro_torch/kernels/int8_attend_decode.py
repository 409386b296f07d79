"""One decode step of attention against a dense int8 KV cache (K5).

``int8_attend_decode_cuda`` launches the Hopper kernel in
``csrc/int8_attend_decode.cu`` (port of
``repro.kernels.int8_attend_decode.int8_attend_decode``, ``kv_bits`` 8
and 4); ``int8_attend_decode_plain`` repeats its arithmetic in PyTorch:

    s32  = q_q . k_q                                (exact integer dot)
    s    = ((s32 - zq*kcol - zk*qrow) + hd*zq*zk) * q_s * k_s
    s    = softcap(s); s = fake_quant_{softmax_in}(s); s = mask(s)
    p    = exp(s - m), l = sum(p)                   (m = max, >= -1e30)
    out  = ((p * v_s) @ v - z_v * sum(p * v_s)) / l

With a calibrated ``softmax_out`` site the probabilities ``exp(s - m) / l``
are fake-quantized first and the output is not renormalised (the
reference's two-pass schedule). The plain version takes the softmax over
all cells at once where the kernel walks them in tiles with an online
(m, l); the two agree up to float rounding. With ``kv_bits=4`` the
cache holds split-half nibbles (``kernels.nibble``), ``(B, S, KV, hd/2)``:
the plain version unpacks them first, the kernel as it loads each row, and
everything after the unpack is the 8-bit arithmetic. With ``out_scale``
(and ``out_zp``, ``qmin``, ``qmax``: one per-tensor grid) the call returns
the output quantized for the next integer matmul, (B, KV*G*hd) int8 =
``peg_quantize`` of the f32 output's rows; the kernel emits it from its
merge (the quantize of K4 folded in), the plain version quantizes its
output. The wrapper counts 8-bit launches in ``launches``, 4-bit ones in
``launches_kv4``, and the launches of either that emit int8 in
``launches_emit``. The helpers here are shared with the paged kernels
(``paged_attend_decode``).

The kernel is split-KV, on the body K6 and K7 run
(``csrc/split_attend.cuh``):
each lane's S cells are cut into contiguous runs (:func:`plan_dense_kv_splits`),
each run's partial softmax state goes to a per-device workspace that the
kernel leaves clean, and the runs merge in split order; with
``softmax_out`` it makes two launches from one C call.

Partial mode (a rank's cells of a cache whose sequence dim is cut over
tensor-parallel ranks): ``int8_attend_decode_partials_*`` write each
split's partial as a row of ``(B, KV, splits, G, prow)`` f32 and merge
nothing. ``mode="one_pass"`` gives ``(acc_j, m_j, l_j)`` (prow hd + 2,
no softmax_out site); with softmax_out ``"stats"`` gives launch 1's
``(m_j, l_j)`` (prow 2) and ``"emit"`` launch 2's ``acc_j`` (prow hd) on
the global ``stats`` (B, KV, G, 2) it is given. The ranks gather the rows
along the split dim, so row ``r * splits + j`` is rank r's split j, and
``merge_partials_*`` (``csrc/merge_partials.cu``) merges them in that
order: ``"one_pass"`` and ``"stats"`` as the in-kernel merge, ``"sum"`` the
second launch's accumulators, with the optional int8 emit. The wrappers
count ``launches`` / ``launches_kv4`` (partials) and ``launches`` /
``launches_emit`` (merges).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _args, _build
from repro_torch.kernels.nibble import unpack_nibbles
from repro_torch.kernels.peg_quant import peg_quantize_plain
from repro_torch.kernels.ref import decode_valid, site_fake_quant

NEG_INF = -1e30
SMS = 132                # streaming multiprocessors of an H100 SXM
MAX_SPLIT_CELLS = 128    # cells a split walks before more splits are cut
MAX_SPLITS = 32          # the split kernel's limit (csrc/split_attend.cuh)
SPLIT_UNIT = 16          # dense cells per unit of a split


def int8_logits(q_q, q_scale, q_zp, k_zp, k_q, k_scale):
    """Attention logits (B, KV, G, S) of int8 queries (B, KV, G, hd) against
    int8 keys (B, S, KV, hd), with the kernel's zero-point corrections in
    its float order. The integer dot runs as a float64 matmul: every partial
    sum is an integer far below 2^53, so it is exact on any device."""
    hd = q_q.shape[-1]
    s32 = torch.einsum("bkgd,bskd->bkgs", q_q.double(),
                       k_q.double()).float()
    kcol = k_q.sum(-1, dtype=torch.int32).float().permute(0, 2, 1)[:, :,
                                                                   None]
    qrow = q_q.sum(-1, dtype=torch.int32).float()[..., None]
    zq = q_zp.float()[..., None]
    zk = k_zp.float()[:, :, None, None]
    acc32 = ((s32 - zq * kcol) - zk * qrow) + (hd * zq) * zk
    ks = k_scale.float().permute(0, 2, 1)[:, :, None]
    return acc32 * q_scale.float()[..., None] * ks


def softmax_attend(s, valid, v, v_scale=None, v_zp=None, *, logit_softcap,
                   sm_quant, sm_qmin, sm_qmax, smo_quant, smo_qmin,
                   smo_qmax):
    """softcap -> softmax_in -> mask -> softmax -> [softmax_out] -> @ V.
    s (B, KV, G, S) f32; valid (B, S) bool; v (B, S, KV, hd) (int8 with
    ``v_scale`` (B, S, KV) and ``v_zp`` (B, KV), else float). Returns
    (B, KV, G, hd) f32."""
    if logit_softcap is not None:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    if sm_quant is not None:
        s = site_fake_quant(s, sm_quant, sm_qmin, sm_qmax)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = torch.clamp_min(s.amax(dim=-1, keepdim=True), NEG_INF)
    p = torch.exp(s - m)
    l = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    if smo_quant is not None:
        p = site_fake_quant(p / l, smo_quant, smo_qmin, smo_qmax)
    if v_scale is not None:
        p = p * v_scale.float().permute(0, 2, 1)[:, :, None]
    acc = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    if v_zp is not None:
        acc = acc - v_zp.float()[:, :, None, None] * p.sum(dim=-1,
                                                           keepdim=True)
    return acc if smo_quant is not None else acc / l


def kv_values(k_q, v_q, hd, kv_bits):
    """The int8 K and V values of an 8-bit or a nibble-packed 4-bit cache."""
    if kv_bits == 4:
        return unpack_nibbles(k_q, hd), unpack_nibbles(v_q, hd)
    if kv_bits != 8:
        raise ValueError(f"attention decode: kv_bits must be 4 or 8, got "
                         f"{kv_bits}")
    return k_q, v_q


def emit_plain(out, out_scale, out_zp, qmin, qmax):
    """The (B, KV, G, hd) f32 output, or with ``out_scale`` its rows
    quantized as K4 quantizes them: (B, KV*G*hd) int8."""
    if out_scale is None:
        return out
    return peg_quantize_plain(out.reshape(out.shape[0], -1), out_scale,
                              0.0 if out_zp is None else out_zp, qmin=qmin,
                              qmax=qmax)


def int8_attend_decode_plain(q_q, q_scale, q_zp, k_zp, v_zp, k_q, k_scale,
                             v_q, v_scale, k_pos, q_pos, *, window,
                             logit_softcap, sm_quant, sm_qmin, sm_qmax,
                             smo_quant, smo_qmin, smo_qmax, kv_bits=8,
                             out_scale=None, out_zp=None, qmin=-128,
                             qmax=127) -> torch.Tensor:
    k_q, v_q = kv_values(k_q, v_q, q_q.shape[-1], kv_bits)
    s = int8_logits(q_q, q_scale, q_zp, k_zp, k_q, k_scale)
    out = softmax_attend(
        s, decode_valid(k_pos, q_pos, window), v_q, v_scale, v_zp,
        logit_softcap=logit_softcap, sm_quant=sm_quant, sm_qmin=sm_qmin,
        sm_qmax=sm_qmax, smo_quant=smo_quant, smo_qmin=smo_qmin,
        smo_qmax=smo_qmax)
    return emit_plain(out, out_scale, out_zp, qmin, qmax)


# -- CUDA launch helpers shared with paged_attend_decode --------------------

MAX_G = 48               # query heads per kv head (csrc/split_attend.cuh)
MAX_G_HD256 = 16         # the widest G at head_dim 256 (kMidG)
MAX_HD_WIDE_G = 128      # head_dim limit past 16 query heads per kv head


def check_query(q, dtype):
    """(B, KV, G, hd) of a decode query the split kernels take: hd % 4 ==
    0, and hd <= 256 with G <= 16 or hd <= 128 with G <= 48 (the queries of
    a kv head sit in static shared memory). Raises on any other shape."""
    if q.dim() != 4 or q.dtype != dtype:
        raise ValueError(f"attention decode: q must be (B, KV, G, hd) "
                         f"{dtype}, got {tuple(q.shape)} {q.dtype}")
    b, kv, g, hd = q.shape
    if hd % 4 or hd > 256 or g > MAX_G or \
            (g > MAX_G_HD256 and hd > MAX_HD_WIDE_G):
        raise ValueError(f"attention decode kernel takes hd % 4 == 0, and "
                         f"hd <= 256 with G <= {MAX_G_HD256} or hd <= "
                         f"{MAX_HD_WIDE_G} with G <= {MAX_G}, got hd={hd} "
                         f"G={g}")
    return b, kv, g, hd


def payload_shape(cells, kv, hd, kv_bits):
    """Shape of a K/V payload over ``cells``: hd int8 values per head, or
    hd/2 bytes of nibbles (hd a multiple of 8, whole 32-bit words)."""
    if kv_bits == 4:
        if hd % 8:
            raise ValueError(f"kv_bits=4 decode kernel takes hd % 8 == 0, "
                             f"got hd={hd}")
        return (*cells, kv, hd // 2)
    if kv_bits != 8:
        raise ValueError(f"attention decode: kv_bits must be 4 or 8, got "
                         f"{kv_bits}")
    return (*cells, kv, hd)


def count_launch(fn, kv_bits, emit=False):
    if kv_bits == 4:
        fn.launches_kv4 += 1
    else:
        fn.launches += 1
    if emit:
        fn.launches_emit += 1


def output(b, kv, g, hd, out_scale, out_zp, device):
    """(out, s_o, z_o): the (B, KV, G, hd) f32 output and None, None; or,
    with ``out_scale``, the (B, KV*G*hd) int8 emit and its per-tensor grid
    (scale and zero-point as (1,) f32 on ``device``)."""
    if out_scale is None:
        return (torch.empty((b, kv, g, hd), dtype=torch.float32,
                            device=device), None, None)
    return (torch.empty((b, kv * g * hd), dtype=torch.int8, device=device),
            _args.f32(out_scale, device, 1, "out_scale"),
            _args.f32(0.0 if out_zp is None else out_zp, device, 1,
                      "out_zp"))


def check_int8(t, shape, what):
    if t.dtype != torch.int8 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected {tuple(shape)} int8, got "
                         f"{tuple(t.shape)} {t.dtype}")
    return t.contiguous()


def f32_like(t, shape, what):
    t = t.to(torch.float32)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    return t.contiguous()


def i32(t, shape, what):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    return t.to(torch.int32).contiguous()


def site_args(sm_quant, smo_quant, device):
    """(softmax_in, softmax_out) [scale, zp] vectors or None, on device."""
    return tuple(None if sq is None else _args.f32(sq, device, 2, "site")
                 for sq in (sm_quant, smo_quant))


def softcap_arg(logit_softcap) -> float:
    return 0.0 if logit_softcap is None else float(logit_softcap)


def window_arg(window) -> int:
    return 0 if window is None else int(window)


def plan_dense_kv_splits(batch, kv, s_len):
    """(splits, cells per split) of K5 for ``batch`` lanes of ``kv`` heads
    over ``s_len`` dense cells, by the rule of
    ``paged_attend_decode.plan_kv_splits`` over units of 16 cells (half a
    cp.async stage, the serving block size): enough splits for the grid to
    reach one wave (``SMS`` blocks) and for no split to hold more than 128
    cells, at most one per unit and at most 32; split j owns the cells
    [j * cps, min(s_len, (j + 1) * cps)), none of them empty."""
    units = max(1, -(-s_len // SPLIT_UNIT))
    want = max(-(-SMS // max(1, batch * kv)),
               -(-s_len // MAX_SPLIT_CELLS))
    per = max(1, units // max(1, min(want, units)), -(-units // MAX_SPLITS))
    cps = per * SPLIT_UNIT
    return max(1, -(-s_len // cps)), cps


def dense_split_cells(s_len, splits, cps):
    """The [first, end) cells of each split, as the kernel cuts them."""
    return [(j * cps, min(s_len, (j + 1) * cps)) for j in range(splits)]


_SCRATCH: dict = {}


def split_scratch(device, stream, n_words, n_counters):
    """The split-KV workspace of K5, K6 and K7 on ``device`` for launches
    on ``stream``: ``n_words`` f32 words of partials and ``n_counters``
    int32 arrival counters, zeroed once (the kernels leave them zeroed).
    Allocated at first use, grown on demand and kept, so a call allocates
    and clears nothing; the launches of one stream run in order, so the
    three kernels share it."""
    key = (device, stream)
    words, counters = _SCRATCH.get(key, (None, None))
    if words is None or words.numel() < n_words:
        words = torch.empty(n_words, dtype=torch.float32, device=device)
    if counters is None or counters.numel() < n_counters:
        counters = torch.zeros(n_counters, dtype=torch.int32, device=device)
    _SCRATCH[key] = (words, counters)
    return words, counters


def _dense_operands(q_q, q_scale, q_zp, k_zp, v_zp, k_q, k_scale, v_q,
                    v_scale, k_pos, q_pos, kv_bits):
    """K5's operands checked and contiguous, and (B, KV, G, hd, S)."""
    b, kv, g, hd = check_query(q_q, torch.int8)
    _args.on_cuda(q_q, k_q, v_q, k_pos, q_pos)
    s_len = k_q.shape[1]
    shape = payload_shape((b, s_len), kv, hd, kv_bits)
    return (q_q.contiguous(), f32_like(q_scale, (b, kv, g), "q_scale"),
            f32_like(q_zp, (b, kv, g), "q_zp"),
            f32_like(k_zp, (b, kv), "k_zp"), f32_like(v_zp, (b, kv), "v_zp"),
            check_int8(k_q, shape, "k_q"),
            f32_like(k_scale, (b, s_len, kv), "k_scale"),
            check_int8(v_q, shape, "v_q"),
            f32_like(v_scale, (b, s_len, kv), "v_scale"),
            i32(k_pos, (b, s_len), "k_pos"),
            i32(q_pos.reshape(-1), (b,), "q_pos")), (b, kv, g, hd, s_len)


def _dense_launch(operands, dims, sites, kv_bits, out, mode=0, part=None,
                  ml_in=None, what="int8_attend_decode"):
    """Launch K5 on ``_dense_operands``; ``sites`` = (window, softcap, sm,
    smo, sm_qmin, sm_qmax, smo_qmin, smo_qmax); ``out`` = (f32 out, int8
    out_q, s_o, z_o, qmin, qmax), all None in a partial mode (``part``
    receives the rows, and the workspace is not used)."""
    b, kv, g, hd, s_len = dims
    window, softcap, sm, smo, sm_qmin, sm_qmax, smo_qmin, smo_qmax = sites
    f32_out, out_q, s_o, z_o, qmin, qmax = out
    splits, cps = plan_dense_kv_splits(b, kv, s_len)
    stream = _args.stream()
    ws = counters = None
    if part is None:
        ws, counters = split_scratch(operands[0].device, stream,
                                     b * kv * splits * g * (hd + 2), b * kv)
    p = _args.ptr
    _build.check(_build.lib("int8_attend_decode").int8_attend_decode(
        *map(p, operands), p(sm), p(smo), p(f32_out), p(out_q), p(s_o),
        p(z_o), qmin, qmax, b, kv, g, hd, s_len, window_arg(window),
        softcap_arg(softcap), sm_qmin, sm_qmax, smo_qmin, smo_qmax, kv_bits,
        splits, cps, p(ws), p(counters), mode, p(part), p(ml_in), stream),
        what)


def int8_attend_decode_cuda(q_q, q_scale, q_zp, k_zp, v_zp, k_q, k_scale,
                            v_q, v_scale, k_pos, q_pos, *, window,
                            logit_softcap, sm_quant, sm_qmin, sm_qmax,
                            smo_quant, smo_qmin, smo_qmax, kv_bits=8,
                            out_scale=None, out_zp=None, qmin=-128,
                            qmax=127) -> torch.Tensor:
    operands, dims = _dense_operands(q_q, q_scale, q_zp, k_zp, v_zp, k_q,
                                     k_scale, v_q, v_scale, k_pos, q_pos,
                                     kv_bits)
    b, kv, g, hd, _ = dims
    dev = operands[0].device
    sm, smo = site_args(sm_quant, smo_quant, dev)
    out, s_o, z_o = output(b, kv, g, hd, out_scale, out_zp, dev)
    emit = s_o is not None
    _dense_launch(operands, dims, (window, logit_softcap, sm, smo, sm_qmin,
                                   sm_qmax, smo_qmin, smo_qmax), kv_bits,
                  (None if emit else out, out if emit else None, s_o, z_o,
                   qmin, qmax))
    count_launch(int8_attend_decode_cuda, kv_bits, emit)
    return out


int8_attend_decode_cuda.launches = int8_attend_decode_cuda.launches_kv4 = 0
int8_attend_decode_cuda.launches_emit = 0


# -- partial mode: a rank's cells, merged across ranks ----------------------

PARTIAL_MODES = {"one_pass": 1, "stats": 2, "emit": 3}   # splitkv::Mode


def partial_row(mode, hd):
    """Floats of one (split, head) partial row: acc and (m, l), (m, l),
    or acc."""
    return {"one_pass": hd + 2, "stats": 2, "emit": hd}[mode]


def check_partial(mode, stats, smo_quant, shape):
    """Raise unless ``mode`` fits the softmax_out site: one pass without
    it, stats / emit with it, ``stats`` (B, KV, G, 2) given to emit only."""
    if mode not in PARTIAL_MODES:
        raise ValueError(f"attention decode partials: mode must be one of "
                         f"{tuple(PARTIAL_MODES)}, got {mode!r}")
    if (mode == "one_pass") != (smo_quant is None):
        raise ValueError("attention decode partials: one_pass takes no "
                         "softmax_out site, stats and emit take one")
    if (mode == "emit") != (stats is not None):
        raise ValueError("attention decode partials: the global stats go to "
                         "emit and only to emit")
    if stats is not None and tuple(stats.shape) != (*shape, 2):
        raise ValueError(f"attention decode partials: stats must be "
                         f"{(*shape, 2)}, got {tuple(stats.shape)}")


def partials_plain(s, valid, v, v_scale, v_zp, bounds, *, mode, stats,
                   logit_softcap, sm_quant, sm_qmin, sm_qmax, smo_quant,
                   smo_qmin, smo_qmax):
    """The partial rows (B, KV, len(bounds), G, prow) f32 of the cells
    [lo, hi) of each split: logits ``s`` (B, KV, G, C), ``valid`` (B, C),
    ``v`` (B, C, KV, hd) with ``v_scale`` / ``v_zp`` as in
    :func:`softmax_attend`. A split's m_j = max(-1e30, max s), p =
    e^(s - m_j), l_j = sum p (emit: p = fq(e^(s - m) / l) on the global
    ``stats``), acc_j = (p * v_s) @ v - z_v * sum(p * v_s)."""
    check_partial(mode, stats, smo_quant, s.shape[:3])
    if logit_softcap is not None:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    if sm_quant is not None:
        s = site_fake_quant(s, sm_quant, sm_qmin, sm_qmax)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    rows = []
    for lo, hi in bounds:
        sj = s[..., lo:hi]
        if mode == "emit":
            m, l = stats[..., :1], stats[..., 1:]
            p = site_fake_quant(torch.exp(sj - m) / l, smo_quant, smo_qmin,
                                smo_qmax)
        else:
            m = torch.clamp_min(sj.amax(dim=-1, keepdim=True), NEG_INF)
            p = torch.exp(sj - m)
            ml = torch.cat([m, p.sum(dim=-1, keepdim=True)], dim=-1)
            if mode == "stats":
                rows.append(ml)
                continue
        if v_scale is not None:
            p = p * v_scale[:, lo:hi].float().permute(0, 2, 1)[:, :, None]
        acc = torch.einsum("bkgs,bskd->bkgd", p, v[:, lo:hi].float())
        if v_zp is not None:
            acc = acc - v_zp.float()[:, :, None, None] * p.sum(dim=-1,
                                                               keepdim=True)
        rows.append(acc if mode == "emit" else torch.cat([acc, ml], dim=-1))
    return torch.stack(rows, dim=2)


def int8_attend_decode_partials_plain(q_q, q_scale, q_zp, k_zp, v_zp, k_q,
                                      k_scale, v_q, v_scale, k_pos, q_pos, *,
                                      mode, stats=None, window, logit_softcap,
                                      sm_quant, sm_qmin, sm_qmax, smo_quant,
                                      smo_qmin, smo_qmax, kv_bits=8):
    """K5's partial rows over these cells, split as the kernel splits them
    (:func:`plan_dense_kv_splits`)."""
    b, kv = q_q.shape[:2]
    s_len = k_pos.shape[1]
    k_q, v_q = kv_values(k_q, v_q, q_q.shape[-1], kv_bits)
    s = int8_logits(q_q, q_scale, q_zp, k_zp, k_q, k_scale)
    return partials_plain(
        s, decode_valid(k_pos, q_pos, window), v_q, v_scale, v_zp,
        dense_split_cells(s_len, *plan_dense_kv_splits(b, kv, s_len)),
        mode=mode, stats=stats, logit_softcap=logit_softcap,
        sm_quant=sm_quant, sm_qmin=sm_qmin, sm_qmax=sm_qmax,
        smo_quant=smo_quant, smo_qmin=smo_qmin, smo_qmax=smo_qmax)


def merge_partials_plain(part, *, mode, out_scale=None, out_zp=None,
                         qmin=-128, qmax=127):
    """Merge the rows (B, KV, P, G, prow) of P partials in row order:
    ``"one_pass"`` the output (m = max(-1e30, max m_j), l = max(sum l_j
    e^(m_j - m), 1e-30), out = sum acc_j e^(m_j - m) / l), ``"stats"`` the
    global (m, l) (B, KV, G, 2), ``"sum"`` the sum of the second launch's
    acc_j. The output is (B, KV, G, hd) f32, or with ``out_scale`` its rows
    quantized as K4 quantizes them, (B, KV*G*hd) int8."""
    if mode not in ("one_pass", "stats", "sum"):
        raise ValueError(f"merge_partials: mode must be one_pass, stats or "
                         f"sum, got {mode!r}")
    if mode == "sum":
        return emit_plain(part.sum(dim=2), out_scale, out_zp, qmin, qmax)
    m_j, l_j = part[..., -2], part[..., -1]
    m = torch.clamp_min(m_j.amax(dim=2, keepdim=True), NEG_INF)
    w = torch.exp(m_j - m)
    l = torch.clamp_min((l_j * w).sum(dim=2), 1e-30)
    if mode == "stats":
        return torch.stack([m[:, :, 0], l], dim=-1)
    out = (part[..., :-2] * w[..., None]).sum(dim=2) / l[..., None]
    return emit_plain(out, out_scale, out_zp, qmin, qmax)


def partial_output(b, kv, splits, g, hd, mode, device):
    return torch.empty((b, kv, splits, g, partial_row(mode, hd)),
                       dtype=torch.float32, device=device)


def stats_arg(stats, shape):
    return None if stats is None else f32_like(stats, (*shape, 2), "stats")


def int8_attend_decode_partials_cuda(q_q, q_scale, q_zp, k_zp, v_zp, k_q,
                                     k_scale, v_q, v_scale, k_pos, q_pos, *,
                                     mode, stats=None, window, logit_softcap,
                                     sm_quant, sm_qmin, sm_qmax, smo_quant,
                                     smo_qmin, smo_qmax, kv_bits=8):
    operands, dims = _dense_operands(q_q, q_scale, q_zp, k_zp, v_zp, k_q,
                                     k_scale, v_q, v_scale, k_pos, q_pos,
                                     kv_bits)
    b, kv, g, hd, s_len = dims
    check_partial(mode, stats, smo_quant, (b, kv, g))
    dev = operands[0].device
    sm, smo = site_args(sm_quant, smo_quant, dev)
    part = partial_output(b, kv, plan_dense_kv_splits(b, kv, s_len)[0], g,
                          hd, mode, dev)
    _dense_launch(operands, dims, (window, logit_softcap, sm, smo, sm_qmin,
                                   sm_qmax, smo_qmin, smo_qmax), kv_bits,
                  (None, None, None, None, -128, 127), PARTIAL_MODES[mode],
                  part, stats_arg(stats, (b, kv, g)),
                  "int8_attend_decode partials")
    count_launch(int8_attend_decode_partials_cuda, kv_bits)
    return part


_MERGE_MODES = {"one_pass": 0, "stats": 1, "sum": 2}


def merge_partials_cuda(part, *, mode, out_scale=None, out_zp=None,
                        qmin=-128, qmax=127):
    if mode not in _MERGE_MODES:
        raise ValueError(f"merge_partials: mode must be one_pass, stats or "
                         f"sum, got {mode!r}")
    _args.on_cuda(part)
    if part.dim() != 5 or part.dtype != torch.float32:
        raise ValueError(f"merge_partials: part must be (B, KV, P, G, prow) "
                         f"f32, got {tuple(part.shape)} {part.dtype}")
    b, kv, n_parts, g, prow = part.shape
    hd = prow - 2 if mode == "one_pass" else prow
    if mode == "stats" and prow != 2:
        raise ValueError(f"merge_partials: stats rows are 2 wide, got {prow}")
    part = part.contiguous()
    dev = part.device
    ml = out = out_q = s_o = z_o = None
    if mode == "stats":
        ml = torch.empty((b, kv, g, 2), dtype=torch.float32, device=dev)
    else:
        out, s_o, z_o = output(b, kv, g, hd, out_scale, out_zp, dev)
        if s_o is not None:
            out, out_q = None, out
    p = _args.ptr
    _build.check(_build.lib("merge_partials").merge_partials(
        p(part), _MERGE_MODES[mode], b, kv, n_parts, g, hd, p(out), p(out_q),
        p(s_o), p(z_o), qmin, qmax, p(ml), _args.stream()), "merge_partials")
    merge_partials_cuda.launches += 1
    if out_q is not None:
        merge_partials_cuda.launches_emit += 1
    return ml if mode == "stats" else (out if out_q is None else out_q)


int8_attend_decode_partials_cuda.launches = 0
int8_attend_decode_partials_cuda.launches_kv4 = 0
merge_partials_cuda.launches = merge_partials_cuda.launches_emit = 0
