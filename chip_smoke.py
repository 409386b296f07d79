#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit before the last line):

1. build   — compile every CUDA kernel from ``src/repro_torch/csrc``.
2. kernels — hold each kernel and each 4-bit variant against its plain
             PyTorch version on the card at the full-width gemma2-2b shapes
             of the serving path (B=4, T=16; attention decode B=4, 4 KV
             heads x 2, head_dim 256, S = 128 and the 4096-cell local
             window), at the reduced shapes and (K8-K10) at the reference
             bench's 4k x 4k, with the tolerances of the CPU parity tests,
             and time kernel, plain version and, where one exists, a
             PyTorch library call computing the same function (CUDA events,
             L2 flushed before every launch). K3 is represented by its
             decode-step shape (4,2304)x(2304,2048), with ``torch._int_mm``
             on A zero-padded to 32 rows as its decode-row yardstick; K4's
             and K10's per-tensor rows have ``torch.quantize_per_tensor`` /
             ``torch.fake_quantize_per_tensor_affine`` beside them; K3's,
             K5's and K6's lines print their split count and achieved GB/s,
             K2's its runs per PEG group x groups per cluster, K1's and
             K8/K9's their row split C (blocks per row, one cluster) and
             blocks and GB/s; K5, K6 and K7 add cases at their split
             boundaries (cells or blocks not a multiple of the split
             length, bs 8, an empty run or hole over a whole split, an idle
             lane, a ring that wrapped; K7 on f32 and bf16 arenas), and
             K5 / K6 / K7 emitting the int8 ``wo`` input from their merge
             must equal K4 on their f32 output bit for bit (timed beside
             that unfused pair).
3. full    — serve gemma2-2b at full width (26 layers, d 2304, bf16) through
             ``repro_torch.launch.serve.main`` with W8A8 PTQ + the integer
             deploy path, static scheduler; the K1/K3/K4 launch counters
             must move.
4. reduced — the README-sized run (``--reduced``): all four counters must
             move, including ``int8_matmul_peg``, which the full-width run
             does not reach (its FFN groups are not uniform, so that FFN
             serves on the fake-quant path).
5. full quickstart — full width with the README quickstart's serving flags
             (int8 paged KV cache, continuous batching, chunked prefill,
             block size 16, max_len 128): K1/K3/K4 and the attention
             kernels K5 (the ``[kv-int8]`` check) and K6 (every decode)
             must move, both with their fused int8 emit; the profiled
             decode step must launch K6's emit and no K4 (K4 keeps the
             prefill and chunk rows).
6. reduced quickstart — exactly the README command with ``--parity``:
             K1-K6 and the emits must move (no K4 in the profiled decode
             step), ``[kv-int8]`` <= 1e-4, the three parity lines must
             print and the serve line must show the reference's counts
             (36 tokens, 10 decode steps, 6 prefills, blocks 16/32, 6 chunk
             steps).
7. reduced paged kv16 — the same command with ``--kv-bits 16``: K7 and
             its int8 emit must move (no K4 in the profiled decode step)
             and the parity lines must print.
8. full quickstart kv16 — phase 5 with ``--kv-bits 16``: the bf16 paged
             cache, every decode step through K7 with its int8 emit
             (and no K4 in the profiled step); K7's device time per call
             in that step and the peak KV-cache bytes beside phase 5's
             print.
9. full quickstart 4-bit — phase 5 with ``--weight-bits 4 --kv-bits 4``:
             K1, K3-w4 (the q4 attention projections), K4, K5-kv4 (the
             ``[kv-int4]`` check) and K6-kv4 (every decode) must move, with
             the emits as in phase 5; the
             q4 payload count, the packed-weight bytes, the ``[kv-int4]``
             lines and the peak KV-cache bytes beside phase 5's print.
10. reduced quickstart 4-bit — phase 6 with the same flags: K2-w4 must move
             too, the counts must be the reference's, and the parity lines
             print as match rates (int4 drift is reported, not asserted, as
             in the reference).
11. entry points — K8-K10, which no ported model reaches, through
             ``ops`` as the reference's kernel bench calls them and (K8)
             through ``deploy.norm_quantize("layernorm", ...)``: each must
             move.

In every serving phase every request must get its tokens. The reduced
runs' integer-path logits must match the fake-quant path they replace
within 1e-4 of max|logits| (the launcher's ``[deploy-int8]`` line); the
full-width gaps are printed only: there the fake-quant path computes in
bf16 (and the bf16 KV cache of the ``[kv-int8]`` reference rounds K/V that
the int8 cache stores on the calibrated grid exactly), and even in f32
values on rounding ties move single grid steps, which 26 layers amplify
(``--f32-parity`` below).

``--ptxas`` first prints nvcc's ``-Xptxas -v`` report (registers, shared
memory, spills) of the split kernels' sources. ``--f32-parity`` first runs
the full-width quickstart's startup checks (``[deploy-int8]``,
``[kv-int8]``, ``[kv-int4]``) and ``--parity`` with f32 params at W8 / kv8
and W4 / kv4, with a layer-by-layer bisect of the integer path against
the fake-quant path (``f32_parity_phase``), printed, not bounded. Prints
the card (``nvidia-smi`` name and power limit), one JSON line with every
kernel's numbers, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero without a result when no CUDA device is available or when the
port's sources are not next to this script.
"""
from __future__ import annotations

import contextlib
import io
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_INT8_OPS_PER_S = 1979e12   # H100 SXM dense int8 tensor-core rate
PEAK_F32_OPS_PER_S = 67e12      # H100 SXM f32 outside the tensor cores
D, FF, Q_OUT, KV_OUT = 2304, 9216, 2048, 1024   # gemma2-2b widths
B, T = 4, 16
ATT_KV, ATT_G, ATT_HD, LOCAL_WINDOW = 4, 2, 256, 4096   # gemma2-2b attention
_CSRC, _TPU = "src/repro_torch/csrc/", "src/repro/kernels/"
# every kernel and 4-bit variant: (its CUDA source, the TPU kernel it
# replaces); the 4-bit variants replace the same TPU entry points
KERNELS = {
    "rms_quantize": ("norm_quant.cu", "fused_ln_quant.py:111"),
    "peg_quantize": ("peg_quant.cu", "peg_quant.py:67"),
    "int8_matmul": ("int8_matmul.cu", "int8_matmul.py:121"),
    "int8_matmul_peg": ("int8_matmul.cu", "int8_matmul.py:245"),
    "int8_attend_decode": ("int8_attend_decode.cu",
                           "int8_attend_decode.py:168"),
    "paged_int8_attend_decode": ("paged_attend_decode.cu",
                                 "paged_attend_decode.py:270"),
    "paged_attend_decode": ("paged_attend_decode.cu",
                            "paged_attend_decode.py:230"),
    "int8_matmul_w4": ("int8_matmul.cu", "int8_matmul.py:121"),
    "int8_matmul_peg_w4": ("int8_matmul.cu", "int8_matmul.py:245"),
    "int8_attend_decode_kv4": ("int8_attend_decode.cu",
                               "int8_attend_decode.py:168"),
    "paged_int8_attend_decode_kv4": ("paged_attend_decode.cu",
                                     "paged_attend_decode.py:270"),
    "ln_quantize": ("norm_quant.cu", "fused_ln_quant.py:93"),
    "rms_fake_quant": ("norm_quant.cu", "fused_ln_quant.py:102"),
    "ln_fake_quant": ("norm_quant.cu", "fused_ln_quant.py:84"),
    "peg_fake_quant": ("peg_quant.cu", "peg_quant.py:38"),
    # K5 / K6 (kv 8 and 4) and K7 emitting the int8 wo input from their
    # merge: the K4 quantize folded in, counted apart from K4's own launches
    "int8_attend_decode_emit": ("int8_attend_decode.cu", "peg_quant.py:67"),
    "paged_int8_attend_decode_emit": ("paged_attend_decode.cu",
                                      "peg_quant.py:67"),
    "paged_attend_decode_emit": ("paged_attend_decode.cu",
                                 "peg_quant.py:67")}


# the port's kernel names in a profiler trace
PORT_KERNELS = (r"norm_quant_kernel|peg_quant_kernel|int8_matmul_splitk|"
                r"int8_matmul_peg_kernel|split_attend_kernel")


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def bound_ms(nbytes, ops, ops_rate):
    """The larger of bytes / HBM rate and operations / peak rate (ms), and
    which of the two it is. ``ops`` / ``ops_rate`` may be sequences of
    operation counts with their rates (int8 products beside f32 ones)."""
    if not isinstance(ops, (list, tuple)):
        ops, ops_rate = (ops,), (ops_rate,)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = sum(o / r for o, r in zip(ops, ops_rate))
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(fn, flush, reps=20):
    """Median device time of one call, L2 flushed before every call. A
    ~0.5 ms device sleep ahead of the start event keeps the card busy while
    the host enqueues the call, so host-side launch overhead is not timed."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def lsb_flips(a, b):
    """(max |a - b| in LSB, count of differing elements) for int8 tensors."""
    d = (a.int() - b.int()).abs()
    return int(d.max().item()), int((d > 0).sum().item())


def split_note(splits, nbytes, ms):
    """The split count and the achieved rate of the bytes the bound
    counts, printed on a split kernel's line."""
    return f"  {splits} splits, {nbytes / (ms * 1e-3) / 1e9:.1f} GB/s"


def peg_note(m, n, k, groups, nbytes, ms):
    """K2's split plan (runs per PEG group x groups per cluster, blocks)
    and the achieved rate of the bytes the bound counts."""
    from repro_torch.kernels import int8_matmul as imm
    bm, bn, runs, per_cluster = imm.plan_peg_splits(m, n, k, groups)
    blocks = -(-m // bm) * -(-n // bn) * runs * per_cluster
    return (f"  {runs} x {per_cluster} splits, {blocks} blocks, "
            f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s")


def row_note(rows, d, groups, nbytes, ms):
    """The row split C of the norm kernels (blocks per row, one cluster),
    their blocks and the achieved rate of the bytes the bound counts."""
    from repro_torch.kernels import fused_ln_quant as lnq
    split = lnq.plan_row_split(rows, d, groups)
    return (f"  C {split}, {rows * split} blocks, "
            f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s")


def torch_yardstick(library, got, flush):
    """(time, note) of one PyTorch call computing a per-tensor quantize
    (``torch.quantize_per_tensor`` / ``torch.fake_quantize_per_tensor_affine``,
    which multiply by the reciprocal of the scale where the kernels divide,
    so some elements may differ: counted in the note, not required
    equal)."""
    off = int((library().float() != got.float()).sum())
    return (time_ms(library, flush),
            f"  library differs on {off} of {got.numel()} elements")


def int_mm_yardstick(a, w, s_a, z_a, s_w, cs, want, flush):
    """Time of ``torch._int_mm`` plus the per-tensor epilogue on the same
    operands (the int8 values of W). ``_int_mm`` takes no fewer than 17
    rows: decode rows (M <= 16) go in zero-padded to 32 (padded once,
    outside the timed call) and the first M rows of the product are
    used."""
    import torch
    m = a.shape[0]
    if m <= 16:
        a = torch.cat([a, torch.zeros((32 - m, a.shape[1]), dtype=a.dtype,
                                      device=a.device)])
    s_prod = s_a * s_w

    def library():
        acc = torch._int_mm(a, w)[:m].float()
        return (acc - z_a * cs.float()) * s_prod
    lib_err = float((library() - want).abs().max())
    require(lib_err <= 1e-5 * float(want.abs().max()),
            f"library yardstick disagrees: {lib_err}")
    return time_ms(library, flush)


def kernel_phase():
    """Phase 2. Returns {kernel name: record} at the representative shape,
    after printing one line per (kernel, shape) case."""
    import torch
    from repro_torch.kernels import fused_ln_quant as lnq
    from repro_torch.kernels import int8_matmul as imm
    from repro_torch.kernels import peg_quant as pq
    from repro_torch.kernels.ref import w_colsum_groups

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def randint8(*shape, lo=-128):
        return torch.randint(lo, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def uniform(n, lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=gen, device=dev)

    records = {}

    def record(name, case, err, ms, plain_ms, lib_ms, nbytes, ops, rate,
               representative, note=""):
        b_ms, by = bound_ms(nbytes, ops, rate)
        print(f"[kernels] {name} {case}: max_abs_err {err:.3e}  kernel "
              f"{ms:.4f} ms  plain {plain_ms:.4f} ms  library "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}  bound "
              f"{b_ms:.4f} ms ({by}){note}")
        rec = records.setdefault(name, {"max_abs_err": 0.0})
        rec["max_abs_err"] = max(rec["max_abs_err"], float(err))
        if representative:
            rec.update(case=case, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=b_ms, bound_by=by)

    # K1 rms_quantize: attn_in (G=1) and a 4-group span layout, bf16 rows
    for rows in (B * T, B):
        for g in (1, 4):
            x = randn(rows, D, dtype=torch.bfloat16) * 3
            gamma = randn(D) * 0.1
            s = uniform(g, 0.02, 0.05)
            z = torch.round(uniform(g, -20, 20))
            kw = dict(qmin=-128, qmax=127)
            got = lnq.rms_quantize_cuda(x, gamma, s, z, **kw)
            want = lnq.rms_quantize_plain(x, gamma, s, z, **kw)
            worst, flips = lsb_flips(got, want)
            require(worst <= 1 and flips <= 1e-3 * got.numel(),
                    f"rms_quantize ({rows},{D}) G={g}: {flips} flips, "
                    f"worst {worst} LSB")
            ms = time_ms(lambda: lnq.rms_quantize_cuda(x, gamma, s, z, **kw),
                         flush)
            p_ms = time_ms(lambda: lnq.rms_quantize_plain(x, gamma, s, z,
                                                          **kw), flush)
            nbytes = rows * D * (2 + 1) + D * 4 + 2 * g * 4
            record("rms_quantize", f"x ({rows},{D}) bf16 G={g}", worst, ms,
                   p_ms, None, nbytes, 8 * rows * D, PEAK_F32_OPS_PER_S,
                   rows == B * T and g == 1,
                   row_note(rows, D, g, nbytes, ms))

    # K4 peg_quantize: the wo input at prefill rows (B*T; decode rows fold
    # it into K5/K6, emit_cases) and B rows, 2048 wide, f32; and bf16 rows
    # in 4 groups (the 16-byte bf16 vectors)
    for rows, d, dtype, g in ((B * T, Q_OUT, torch.float32, 1),
                              (B, Q_OUT, torch.float32, 1),
                              (B * T, D, torch.bfloat16, 4)):
        x = randn(rows, d, dtype=dtype)
        s = uniform(g, 0.01, 0.03)
        z = torch.round(uniform(g, -10, 10))
        kw = dict(qmin=-128, qmax=127)
        got = pq.peg_quantize_cuda(x, s, z, **kw)
        want = pq.peg_quantize_plain(x, s, z, **kw)
        shape = f"x ({rows},{d}) {str(dtype)[6:]} G={g}"
        require(torch.equal(got, want), f"peg_quantize {shape} not "
                f"bit-exact")
        ms = time_ms(lambda: pq.peg_quantize_cuda(x, s, z, **kw), flush)
        p_ms = time_ms(lambda: pq.peg_quantize_plain(x, s, z, **kw), flush)
        lib_ms, note = None, ""
        if g == 1:
            lib_ms, note = torch_yardstick(
                lambda: torch.quantize_per_tensor(
                    x, float(s), int(z), torch.qint8).int_repr(), got, flush)
        record("peg_quantize", shape, 0.0, ms, p_ms, lib_ms,
               rows * d * (x.element_size() + 1) + 8 * g, 4 * rows * d,
               PEAK_F32_OPS_PER_S, rows == B * T and g == 1, note)

    # K3 int8_matmul: wq, wk/wv, wo, w_out at prefill (B*T) and decode (B)
    for k, n in ((D, Q_OUT), (D, KV_OUT), (Q_OUT, D), (FF, D)):
        for m in (B * T, B):
            a = randint8(m, k)
            w = randint8(k, n, lo=-127)
            cs = w_colsum_groups(w, 1)[0]
            s_a, z_a, s_w = uniform(1, 0.01, 0.03), torch.round(
                uniform(1, -20, 20)), uniform(1, 0.001, 0.01)
            kw = dict(z_a=z_a, w_colsum=cs)
            got = imm.int8_matmul_cuda(a, w, s_a, s_w, **kw)
            want = imm.int8_matmul_plain(a, w, s_a, s_w, **kw)
            err = float((got - want).abs().max())
            require(err <= 1e-5 * float(want.abs().max()),
                    f"int8_matmul ({m},{k})x({k},{n}): max err {err}")
            ms = time_ms(lambda: imm.int8_matmul_cuda(a, w, s_a, s_w, **kw),
                         flush)
            p_ms = time_ms(lambda: imm.int8_matmul_plain(a, w, s_a, s_w,
                                                         **kw), flush)
            lib_ms = int_mm_yardstick(a, w, s_a, z_a, s_w, cs, want, flush)
            nbytes = m * k + k * n + n * 4 + m * n * 4
            record("int8_matmul", f"({m},{k})x({k},{n}) f32 out", err, ms,
                   p_ms, lib_ms, nbytes, 2 * m * n * k, PEAK_INT8_OPS_PER_S,
                   m == B and (k, n) == (D, Q_OUT),
                   split_note(imm.plan_k_splits(m, n, k)[2], nbytes, ms))

    # K2 int8_matmul_peg: w_up (f32 out) and w_gate (gelu * up -> int8),
    # 576-wide (G=4) and 384-wide (G=6) groups, and the reduced width's
    # 4 x 16 groups at the quickstart's decode rows
    for m, k, n, g in ((B * T, D, FF, 4), (B, D, FF, 4), (B * T, D, FF, 6),
                       (B, D, FF, 6), (2 * B, 64, 128, 4)):
        a = randint8(m, k)
        w = randint8(k, n, lo=-127)
        cs = w_colsum_groups(w, g)
        sg = uniform(g, 0.01, 0.05)
        zg = torch.round(uniform(g, -20, 20))
        s_w = uniform(1, 0.001, 0.01)
        up = randn(m, n)
        for requant in (False, True):
            kw = (dict(activation="gelu", mul=up, out_scale=uniform(
                1, 0.02, 0.04), out_zp=torch.round(uniform(1, -5, 5)))
                  if requant else {})
            got = imm.int8_matmul_peg_cuda(a, w, sg, zg, s_w, cs, **kw)
            want = imm.int8_matmul_peg_plain(a, w, sg, zg, s_w, cs, **kw)
            if requant:
                worst, flips = lsb_flips(got, want)
                require(worst <= 1 and flips <= 1e-3 * got.numel(),
                        f"int8_matmul_peg G={g} requant: {flips} flips,"
                        f" worst {worst} LSB")
                err = float(worst)
            else:
                err = float((got - want).abs().max())
                require(err <= 1e-5 * float(want.abs().max()),
                        f"int8_matmul_peg G={g}: max err {err}")
            ms = time_ms(lambda: imm.int8_matmul_peg_cuda(
                a, w, sg, zg, s_w, cs, **kw), flush)
            p_ms = time_ms(lambda: imm.int8_matmul_peg_plain(
                a, w, sg, zg, s_w, cs, **kw), flush)
            nbytes = (m * k + k * n + g * n * 4 + 2 * g * 4 +
                      (m * n * (4 + 1) if requant else m * n * 4))
            out = "gelu*mul->int8" if requant else "f32 out"
            record("int8_matmul_peg", f"({m},{k})x({k},{n}) G={g} {out}",
                   err, ms, p_ms, None, nbytes, 2 * m * n * k,
                   PEAK_INT8_OPS_PER_S,
                   (m, k, g) == (B * T, D, 4) and not requant,
                   peg_note(m, n, k, g, nbytes, ms))
    w4_cases(gen, flush, record, randint8, uniform, randn)
    norm_cases(gen, flush, record, uniform, randn)
    attend_cases(gen, flush, record)
    return records


def w4_cases(gen, flush, record, randint8, uniform, randn):
    """The w_bits=4 variants of K3 and K2: (K/2, N) pairwise-row nibbles
    against the plain version (which unpacks, then computes as at 8 bits),
    at the full-width shapes of the 4-bit serving path and the reduced
    width's 16-wide PEG groups. The library yardstick of K3-w4 is
    ``torch._int_mm`` on the unpacked weight plus the epilogue."""
    import torch
    from repro_torch.kernels import int8_matmul as imm
    from repro_torch.kernels.nibble import pack_rows
    from repro_torch.kernels.ref import w_colsum_groups
    dev = torch.device("cuda")

    def w4(k, n):
        w = torch.randint(-7, 8, (k, n), generator=gen, device=dev,
                          dtype=torch.int8)
        return w, pack_rows(w)

    # K3-w4: wq (and the M = 4 decode rows)
    for m in (B * T, B):
        k, n = D, Q_OUT
        a = randint8(m, k)
        w, w_pk = w4(k, n)
        cs = w_colsum_groups(w, 1)[0]
        s_a, z_a, s_w = uniform(1, 0.01, 0.03), torch.round(
            uniform(1, -20, 20)), uniform(1, 0.001, 0.01)
        kw = dict(z_a=z_a, w_colsum=cs, w_bits=4)
        got = imm.int8_matmul_cuda(a, w_pk, s_a, s_w, **kw)
        want = imm.int8_matmul_plain(a, w_pk, s_a, s_w, **kw)
        err = float((got - want).abs().max())
        require(err <= 1e-5 * float(want.abs().max()),
                f"int8_matmul w4 ({m},{k})x({k},{n}): max err {err}")
        ms = time_ms(lambda: imm.int8_matmul_cuda(a, w_pk, s_a, s_w, **kw),
                     flush)
        p_ms = time_ms(lambda: imm.int8_matmul_plain(a, w_pk, s_a, s_w,
                                                     **kw), flush)
        lib_ms = int_mm_yardstick(a, w, s_a, z_a, s_w, cs, want, flush)
        nbytes = m * k + k // 2 * n + n * 4 + m * n * 4
        record("int8_matmul_w4", f"({m},{k})x({k}/2,{n}) int4 f32 out", err,
               ms, p_ms, lib_ms, nbytes, 2 * m * n * k, PEAK_INT8_OPS_PER_S,
               m == B, split_note(imm.plan_k_splits(m, n, k)[2], nbytes, ms))

    # K2-w4: w_gate / w_up at full width (G=4) and the reduced 4 x 16 groups
    for m, k, n, g in ((B * T, D, FF, 4), (B, D, FF, 4), (B * T, 64, 128, 4)):
        a = randint8(m, k)
        w, w_pk = w4(k, n)
        cs = w_colsum_groups(w, g)
        sg = uniform(g, 0.01, 0.05)
        zg = torch.round(uniform(g, -20, 20))
        s_w = uniform(1, 0.001, 0.01)
        up = randn(m, n)
        for requant in (False, True):
            kw = dict(w_bits=4)
            if requant:
                kw.update(activation="gelu", mul=up, out_scale=uniform(
                    1, 0.02, 0.04), out_zp=torch.round(uniform(1, -5, 5)))
            got = imm.int8_matmul_peg_cuda(a, w_pk, sg, zg, s_w, cs, **kw)
            want = imm.int8_matmul_peg_plain(a, w_pk, sg, zg, s_w, cs, **kw)
            if requant:
                worst, flips = lsb_flips(got, want)
                require(worst <= 1 and flips <= 1e-3 * got.numel(),
                        f"int8_matmul_peg w4 G={g} requant: {flips} flips, "
                        f"worst {worst} LSB")
                err = float(worst)
            else:
                err = float((got - want).abs().max())
                require(err <= 1e-5 * float(want.abs().max()),
                        f"int8_matmul_peg w4 G={g}: max err {err}")
            ms = time_ms(lambda: imm.int8_matmul_peg_cuda(
                a, w_pk, sg, zg, s_w, cs, **kw), flush)
            p_ms = time_ms(lambda: imm.int8_matmul_peg_plain(
                a, w_pk, sg, zg, s_w, cs, **kw), flush)
            nbytes = (m * k + k // 2 * n + g * n * 4 + 2 * g * 4 +
                      (m * n * (4 + 1) if requant else m * n * 4))
            out = "gelu*mul->int8" if requant else "f32 out"
            record("int8_matmul_peg_w4",
                   f"({m},{k})x({k}/2,{n}) int4 G={g} {out}", err, ms, p_ms,
                   None, nbytes, 2 * m * n * k, PEAK_INT8_OPS_PER_S,
                   (m, k) == (B * T, D) and not requant,
                   peg_note(m, n, k, g, nbytes, ms))


def norm_cases(gen, flush, record, uniform, randn):
    """K8 (LayerNorm + int8 emit), K9a / K9b (RMSNorm / LayerNorm
    fake-quant) and K10 (PEG fake-quant) at the serving path's row shape
    (64 x 2304 bf16) and the reference bench's 4k x 4k f32. The int8 emit
    may differ by 1 LSB on at most 0.1 % of elements (the row reductions
    run in another order), a fake-quant output by one grid step (and its
    dtype's rounding) on as many; K10 is bit-exact. No single PyTorch call computes them:
    ``F.layer_norm`` has no quantizer and no int8 emit."""
    import torch
    from repro_torch.kernels import fused_ln_quant as lnq
    from repro_torch.kernels import peg_quant as pq

    def steps_off(got, want, s, d):
        """(max |got - want|, elements off) with each off element at most
        one grid step away, plus the rounding of the output's dtype (a
        bf16 value carries 8 significant bits)."""
        err = (got.float() - want.float()).abs()
        step = s.repeat_interleave(d // s.numel())[None, :]
        eps = torch.finfo(got.dtype).eps
        require(bool((err <= step * 1.01 + want.float().abs() * eps).all()),
                "fake-quant output more than one grid step away")
        return float(err.max()), int((err > 0).sum())

    for rows, d, dtype, groups in ((B * T, D, torch.bfloat16, (1, 4)),
                                   (4096, 4096, torch.float32, (8,))):
        el = 2 if dtype == torch.bfloat16 else 4
        x = randn(rows, d, dtype=dtype) * 3
        gamma = 1 + randn(d) * 0.1
        beta = randn(d) * 0.1
        for g in groups:
            s = uniform(g, 0.02, 0.05)
            z = torch.round(uniform(g, -20, 20))
            kw = dict(qmin=-128, qmax=127)
            shape = f"x ({rows},{d}) {str(dtype)[6:]} G={g}"
            rep = rows == B * T and g == 1
            for name, affine, emit in (
                    ("ln_quantize", (gamma, beta), True),
                    ("rms_fake_quant", (gamma,), False),
                    ("ln_fake_quant", (gamma, beta), False)):
                if emit and rows != B * T:
                    continue
                cuda = getattr(lnq, name + "_cuda")
                plain = getattr(lnq, name + "_plain")
                got = cuda(x, *affine, s, z, **kw)
                want = plain(x, *affine, s, z, **kw)
                if emit:
                    err, flips = lsb_flips(got, want)
                    require(err <= 1, f"{name} {shape}: {err} LSB")
                else:
                    require(got.dtype == dtype, f"{name}: dtype {got.dtype}")
                    err, flips = steps_off(got, want, s, d)
                require(flips <= 1e-3 * got.numel(),
                        f"{name} {shape}: {flips} flips")
                ms = time_ms(lambda: cuda(x, *affine, s, z, **kw), flush)
                p_ms = time_ms(lambda: plain(x, *affine, s, z, **kw), flush)
                nbytes = (rows * d * (el + (1 if emit else el)) +
                          len(affine) * d * 4 + 2 * g * 4)
                record(name, shape, err, ms, p_ms, None, nbytes,
                       10 * rows * d, PEAK_F32_OPS_PER_S, rep,
                       row_note(rows, d, g, nbytes, ms))
            got = pq.peg_fake_quant_cuda(x, s, z, **kw)
            want = pq.peg_fake_quant_plain(x, s, z, **kw)
            require(torch.equal(got, want),
                    f"peg_fake_quant {shape} not bit-exact")
            ms = time_ms(lambda: pq.peg_fake_quant_cuda(x, s, z, **kw),
                         flush)
            p_ms = time_ms(lambda: pq.peg_fake_quant_plain(x, s, z, **kw),
                           flush)
            lib_ms, note = None, ""
            if g == 1:
                lib_ms, note = torch_yardstick(
                    lambda: torch.fake_quantize_per_tensor_affine(
                        x, float(s), int(z), -128, 127), got, flush)
            record("peg_fake_quant", shape, 0.0, ms, p_ms, lib_ms,
                   rows * d * 2 * el + 2 * g * 4, 6 * rows * d,
                   PEAK_F32_OPS_PER_S, rep, note)


SITES = {"no sites": {},
         "softmax_in + zero-points": dict(sm_quant=(0.05, 128.0)),
         "two-pass softmax_out + zero-points": dict(
             sm_quant=(0.05, 128.0), smo_quant=(1 / 255, 0.0))}


def attend_check(got, want, smo_step, v_absmax):
    """Kernel vs plain version: within 1e-5 of max|out|; with a
    softmax_out site at most 0.1 % of the rows may differ more (a
    probability on a grid tie lands one step away), each by at most one
    softmax_out step x max|v|. Returns max |got - want|."""
    import torch
    err = (got - want).abs()
    tol = 1e-5 * float(want.abs().max())
    worst = float(err.max())
    if smo_step is None:
        require(worst <= tol, f"max err {worst} > {tol}")
    else:
        rows = err.amax(dim=-1)
        off = int((rows > tol).sum())
        require(off <= 1e-3 * rows.numel(),
                f"{off} of {rows.numel()} rows off by more than {tol}")
        require(worst <= smo_step * v_absmax * (1 + 1e-5),
                f"max err {worst} > one softmax_out step x max|v|")
    require(bool(torch.isfinite(got).all()), "non-finite output")
    return worst


def attend_cases(gen, flush, record):
    """K5-K7 at the full-width decode shapes (B 4, 4 KV heads x G 2,
    head_dim 256; S = max_len 128 and the 4096-cell local window; paged
    with block size 16) and the reduced ones (2 KV heads, head_dim 16,
    ring s_cap 16), each without sites, with softmax_in and zero-points and
    with the two-pass softmax_out, all with softcap 50 and a window; then
    K5-kv4 and K6-kv4 at the full-width shapes, with holes and an idle
    lane. The bound counts what the inputs need: the payload and scales of
    the cells that are valid for some query (read once), positions or the
    block table, the queries, the output."""
    import torch
    from repro_torch.kernels import int8_attend_decode as iad
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attend_decode as pad
    from repro_torch.kernels.nibble import pack_nibbles
    from repro_torch.kernels.ref import decode_valid, paged_positions_ref
    dev = torch.device("cuda")

    def ri(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def ru(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    def site_kw(name):
        kw = dict(sm_quant=None, sm_qmin=0, sm_qmax=255, smo_quant=None,
                  smo_qmin=0, smo_qmax=255)
        for k, v in SITES[name].items():
            kw[k] = torch.tensor(v, device=dev)
        return kw

    def measure(name, case, fn_cuda, fn_plain, args, kw, valid, kv, g, hd,
                payload_bytes, meta_bytes, q_bytes, v_absmax, quant,
                representative, splits=None):
        b = valid.shape[0]
        got = fn_cuda(*args, **kw)
        want = fn_plain(*args, **kw)
        torch.cuda.synchronize()
        smo = kw.get("smo_quant")
        err = attend_check(got, want, None if smo is None else
                           float(smo[0]), v_absmax)
        ms = time_ms(lambda: fn_cuda(*args, **kw), flush)
        p_ms = time_ms(lambda: fn_plain(*args, **kw), flush)
        # cells valid for the lane's query need their payload and scales
        n_valid = int(valid.sum())
        nbytes = (n_valid * kv * payload_bytes + meta_bytes + q_bytes
                  + b * kv * g * hd * 4)
        macs = n_valid * kv * g * hd
        record(name, case, err, ms, p_ms, None, nbytes,
               [2 * macs, 2 * macs],
               [PEAK_INT8_OPS_PER_S if quant else PEAK_F32_OPS_PER_S,
                PEAK_F32_OPS_PER_S], representative,
               "" if splits is None else split_note(splits, nbytes, ms))

    full = (4, ATT_KV, ATT_G, ATT_HD)
    reduced = (4, 2, 2, 16)
    # K5: dense int8 cache
    for (b, kv, g, hd), s_len, window in (
            (full, 128, 64), (full, LOCAL_WINDOW, LOCAL_WINDOW // 2),
            (reduced, 64, 16), (reduced, 16, 16)):
        for site in SITES:
            zp = site != "no sites"
            q_q = ri(b, kv, g, hd)
            q_s = ru(0.01, 0.03, b, kv, g) / 16
            zq = torch.round(ru(-20, 20, b, kv, g)) if zp else \
                torch.zeros(b, kv, g, device=dev)
            zk, zv = ((torch.round(ru(-20, 20, b, kv)) if zp else
                       torch.zeros(b, kv, device=dev)) for _ in range(2))
            k_q, v_q = ri(b, s_len, kv, hd), ri(b, s_len, kv, hd)
            k_s, v_s = ru(0.01, 0.05, b, s_len, kv), ru(0.01, 0.05, b,
                                                       s_len, kv)
            k_pos = torch.arange(s_len, device=dev,
                                 dtype=torch.int32).repeat(b, 1)
            q_pos = torch.full((b,), s_len - 1, device=dev,
                               dtype=torch.int32)
            if s_len == 16:   # a ring that wrapped: slot j holds 8..23
                k_pos = torch.where(k_pos < 8, k_pos + 16, k_pos)
                q_pos = q_pos + 8
            kw = dict(window=window, logit_softcap=50.0, **site_kw(site))
            valid = decode_valid(k_pos, q_pos, window)
            v_abs = float((v_q.float().abs().max() + zv.abs().max())
                          * v_s.max())
            measure("int8_attend_decode",
                    f"B{b} KV{kv}xG{g} hd{hd} S{s_len} w{window}, {site}",
                    iad.int8_attend_decode_cuda, iad.int8_attend_decode_plain,
                    (q_q, q_s, zq, zk, zv, k_q, k_s, v_q, v_s, k_pos, q_pos),
                    kw, valid, kv, g, hd, 2 * hd + 8, b * s_len * 4 + b * 4,
                    b * kv * g * (hd + 8) + b * kv * 8, v_abs, True,
                    s_len == 128 and site.startswith("two-pass"),
                    iad.plan_dense_kv_splits(b, kv, s_len)[0])
    # an idle lane and an empty-prefix lane at the full width
    b, kv, g, hd = full
    k_pos = torch.arange(128, device=dev, dtype=torch.int32).repeat(b, 1)
    k_pos[1, :40] = -1
    q_pos = torch.tensor([127, 127, 60, -1], device=dev, dtype=torch.int32)
    args = (ri(b, kv, g, hd), ru(0.01, 0.03, b, kv, g) / 16,
            torch.zeros(b, kv, g, device=dev), torch.zeros(b, kv, device=dev),
            torch.zeros(b, kv, device=dev), ri(b, 128, kv, hd),
            ru(0.01, 0.05, b, 128, kv), ri(b, 128, kv, hd),
            ru(0.01, 0.05, b, 128, kv), k_pos, q_pos)
    kw = dict(window=None, logit_softcap=50.0, **site_kw("no sites"))
    measure("int8_attend_decode", "idle lane + empty prefix, S128",
            iad.int8_attend_decode_cuda, iad.int8_attend_decode_plain, args,
            kw, decode_valid(k_pos, q_pos, None), kv, g, hd, 2 * hd + 8,
            b * 128 * 4 + b * 4, b * kv * g * (hd + 8) + b * kv * 8, 1.0,
            True, False, iad.plan_dense_kv_splits(b, kv, 128)[0])

    # K6 / K7: paged arenas through a block table
    for (b, kv, g, hd), bs, s_cap, nb, window in (
            (full, 16, 128, 8, 64), (full, 16, LOCAL_WINDOW, 256,
                                     LOCAL_WINDOW // 2),
            (reduced, 8, 64, 8, None), (reduced, 8, 16, 8, 16)):
        n_blocks = b * nb + 5
        for holes in (False, True):
            table = torch.randperm(n_blocks, generator=gen, device=dev)[
                :b * nb].reshape(b, nb).to(torch.int32)
            q_pos = torch.full((b,), s_cap - 1, device=dev,
                               dtype=torch.int32)
            if s_cap == 16:
                q_pos = q_pos + 9                  # the ring wrapped
            if holes:            # unmapped tails, a short lane, an idle one
                table[0, nb // 2:] = -1
                table[1, 1:] = -1
                q_pos[1] = min(int(q_pos[1]), bs - 1)
                q_pos[3] = -1
            cols = ops._lane_blocks(table, s_cap, bs).contiguous()
            valid = decode_valid(paged_positions_ref(
                cols, q_pos, s_cap=s_cap, block_size=bs), q_pos, window)
            meta = cols.numel() * 4 + b * 4
            for site in (SITES if not holes else ("two-pass softmax_out + "
                                                  "zero-points",)):
                zp = site != "no sites"
                kwq = dict(s_cap=s_cap, window=window, logit_softcap=50.0,
                           **site_kw(site))
                k_a, v_a = ri(n_blocks, bs, kv, hd), ri(n_blocks, bs, kv, hd)
                k_s, v_s = ru(0.01, 0.05, n_blocks, bs, kv), ru(
                    0.01, 0.05, n_blocks, bs, kv)
                zk, zv = ((torch.round(ru(-20, 20, b, kv)) if zp else
                           torch.zeros(b, kv, device=dev)) for _ in range(2))
                zq = torch.round(ru(-20, 20, b, kv, g)) if zp else \
                    torch.zeros(b, kv, g, device=dev)
                q_q = ri(b, kv, g, hd)
                v_abs = float((v_a.float().abs().max() + zv.abs().max())
                              * v_s.max())
                shape = (f"B{b} KV{kv}xG{g} hd{hd} bs{bs} s_cap{s_cap} "
                         f"w{window}{' holes+idle' if holes else ''}")
                measure("paged_int8_attend_decode", f"{shape}, {site}",
                        pad.paged_int8_attend_decode_cuda,
                        pad.paged_int8_attend_decode_plain,
                        (q_q, ru(0.01, 0.03, b, kv, g) / 16, zq, zk, zv, k_a,
                         k_s, v_a, v_s, cols, q_pos), kwq, valid, kv, g, hd,
                        2 * hd + 8, meta,
                        b * kv * g * (hd + 8) + b * kv * 8, v_abs, True,
                        s_cap == 128 and not holes
                        and site.startswith("two-pass"),
                        pad.plan_kv_splits(b, kv, cols.shape[1], bs)[0])
                # K7 serves bf16 arenas at full width, f32 at reduced
                fdt = torch.bfloat16 if hd == ATT_HD else torch.float32
                qf = torch.randn(b, kv, g, hd, generator=gen, device=dev) \
                    * 0.3 / hd ** 0.5
                kf = torch.randn(n_blocks, bs, kv, hd, generator=gen,
                                 device=dev).to(fdt)
                vf = torch.randn(n_blocks, bs, kv, hd, generator=gen,
                                 device=dev).to(fdt)
                el = 2 if fdt == torch.bfloat16 else 4
                measure("paged_attend_decode",
                        f"{shape} {str(fdt)[6:]}, "
                        f"{site.replace(' + zero-points', '')}",
                        pad.paged_attend_decode_cuda,
                        pad.paged_attend_decode_plain,
                        (qf, kf, vf, cols, q_pos), kwq, valid, kv, g, hd,
                        2 * hd * el, meta, b * kv * g * hd * 4,
                        float(vf.float().abs().max()), False,
                        s_cap == 128 and not holes
                        and site.startswith("two-pass"),
                        pad.plan_kv_splits(b, kv, cols.shape[1], bs)[0])

    # K5 / K6 at kv_bits=4: nibble-packed (.., KV, hd/2) payloads of int4
    # values, int4 zero-points; a cell needs hd bytes of payload + scales
    def kv4(*shape):
        return pack_nibbles(torch.randint(-8, 8, shape, generator=gen,
                                          device=dev, dtype=torch.int8))

    def zp4(zp, *shape):
        return torch.round(ru(-3, 3, *shape)) if zp else \
            torch.zeros(shape, device=dev)
    b, kv, g, hd = full
    for s_len, window, site, idle in (
            (128, 64, "two-pass softmax_out + zero-points", False),
            (128, 64, "no sites", False),
            (128, None, "two-pass softmax_out + zero-points", True),
            (LOCAL_WINDOW, LOCAL_WINDOW // 2, "no sites", False),
            (LOCAL_WINDOW, LOCAL_WINDOW // 2,
             "two-pass softmax_out + zero-points", False)):
        zp = site != "no sites"
        k_pos = torch.arange(s_len, device=dev, dtype=torch.int32).repeat(
            b, 1)
        q_pos = torch.full((b,), s_len - 1, device=dev, dtype=torch.int32)
        if idle:                      # an empty prefix and an idle lane
            k_pos[1, :40] = -1
            q_pos[2], q_pos[3] = 60, -1
        zv = zp4(zp, b, kv)
        v_s = ru(0.1, 0.5, b, s_len, kv)
        args = (ri(b, kv, g, hd), ru(0.01, 0.03, b, kv, g) / 16,
                torch.round(ru(-20, 20, b, kv, g)) if zp else
                torch.zeros(b, kv, g, device=dev), zp4(zp, b, kv), zv,
                kv4(b, s_len, kv, hd), ru(0.1, 0.5, b, s_len, kv),
                kv4(b, s_len, kv, hd), v_s, k_pos, q_pos)
        kw = dict(window=window, logit_softcap=50.0, kv_bits=4,
                  **site_kw(site))
        measure("int8_attend_decode_kv4",
                f"B{b} KV{kv}xG{g} hd{hd} S{s_len} w{window}"
                f"{' holes+idle' if idle else ''}, {site}",
                iad.int8_attend_decode_cuda, iad.int8_attend_decode_plain,
                args, kw, decode_valid(k_pos, q_pos, window), kv, g, hd,
                hd + 8, b * s_len * 4 + b * 4,
                b * kv * g * (hd + 8) + b * kv * 8,
                float((8 + zv.abs().max()) * v_s.max()), True,
                s_len == 128 and not idle and site.startswith("two-pass"),
                iad.plan_dense_kv_splits(b, kv, s_len)[0])
    bs = 16
    for s_cap, nb, window, site, holes in (
            (128, 8, 64, "two-pass softmax_out + zero-points", False),
            (128, 8, 64, "no sites", False),
            (128, 8, 64, "two-pass softmax_out + zero-points", True),
            (LOCAL_WINDOW, 256, LOCAL_WINDOW // 2,
             "two-pass softmax_out + zero-points", False)):
        zp = site != "no sites"
        n_blocks = b * nb + 5
        table = torch.randperm(n_blocks, generator=gen, device=dev)[
            :b * nb].reshape(b, nb).to(torch.int32)
        q_pos = torch.full((b,), s_cap - 1, device=dev, dtype=torch.int32)
        if holes:
            table[0, nb // 2:] = -1
            table[1, 1:] = -1
            q_pos[1], q_pos[3] = bs - 1, -1
        cols = ops._lane_blocks(table, s_cap, bs).contiguous()
        valid = decode_valid(paged_positions_ref(
            cols, q_pos, s_cap=s_cap, block_size=bs), q_pos, window)
        zv = zp4(zp, b, kv)
        v_s = ru(0.1, 0.5, n_blocks, bs, kv)
        args = (ri(b, kv, g, hd), ru(0.01, 0.03, b, kv, g) / 16,
                torch.round(ru(-20, 20, b, kv, g)) if zp else
                torch.zeros(b, kv, g, device=dev), zp4(zp, b, kv), zv,
                kv4(n_blocks, bs, kv, hd), ru(0.1, 0.5, n_blocks, bs, kv),
                kv4(n_blocks, bs, kv, hd), v_s, cols, q_pos)
        kw = dict(s_cap=s_cap, window=window, logit_softcap=50.0, kv_bits=4,
                  **site_kw(site))
        measure("paged_int8_attend_decode_kv4",
                f"B{b} KV{kv}xG{g} hd{hd} bs{bs} s_cap{s_cap} w{window}"
                f"{' holes+idle' if holes else ''}, {site}",
                pad.paged_int8_attend_decode_cuda,
                pad.paged_int8_attend_decode_plain, args, kw, valid, kv, g,
                hd, hd + 8, cols.numel() * 4 + b * 4,
                b * kv * g * (hd + 8) + b * kv * 8,
                float((8 + zv.abs().max()) * v_s.max()), True,
                s_cap == 128 and not holes and site.startswith("two-pass"),
                pad.plan_kv_splits(b, kv, cols.shape[1], bs)[0])
    k6_split_cases(gen, ri, ru, site_kw, measure)
    k5_split_cases(gen, ri, ru, site_kw, measure)
    k7_split_cases(gen, site_kw, measure)
    emit_cases(gen, flush, record, ri, ru, site_kw)


def emit_cases(gen, flush, record, ri, ru, site_kw):
    """K6 and K5 (kv 8 and 4) and K7 (bf16 and f32 arenas) emitting the
    int8 input of the output projection from their merge, at the
    full-width decode shapes: one and two passes, holes and an idle lane,
    the split boundaries of ``k6_split_cases`` / ``k5_split_cases``. The
    emit must equal K4's kernel on the same call's f32 output bit for
    bit; that f32 output must pass ``attend_check`` against the plain
    version, and the emit may differ from the plain emit (the plain
    attention, then ``peg_quantize_plain``) by 1 LSB plus that bound in
    steps of the output grid. Times the emitting call beside the unfused
    pair (the f32 call, then K4)."""
    import torch
    from repro_torch.kernels import int8_attend_decode as iad
    from repro_torch.kernels import paged_attend_decode as pad
    from repro_torch.kernels import peg_quant as pq
    from repro_torch.kernels.nibble import pack_nibbles
    from repro_torch.kernels.ref import decode_valid, paged_positions_ref
    dev = torch.device("cuda")
    b, kv, g, hd = 4, ATT_KV, ATT_G, ATT_HD
    q8 = dict(qmin=-128, qmax=127)

    def operands(cells, kv_bits):
        """Payloads, scales and zero-points over ``cells`` (a shape)."""
        if kv_bits == 4:
            k, v = (pack_nibbles(torch.randint(
                -8, 8, (*cells, kv, hd), generator=gen, device=dev,
                dtype=torch.int8)) for _ in range(2))
            zk, zv = (torch.round(ru(-3, 3, b, kv)) for _ in range(2))
            v_s = ru(0.1, 0.5, *cells, kv)
            v_abs = float((8 + zv.abs().max()) * v_s.max())
        else:
            k, v = ri(*cells, kv, hd), ri(*cells, kv, hd)
            zk, zv = (torch.round(ru(-20, 20, b, kv)) for _ in range(2))
            v_s = ru(0.01, 0.05, *cells, kv)
            v_abs = float((v.float().abs().max() + zv.abs().max())
                          * v_s.max())
        return (ri(b, kv, g, hd), ru(0.01, 0.03, b, kv, g) / 16,
                torch.round(ru(-20, 20, b, kv, g)), zk, zv, k,
                ru(0.01, 0.05, *cells, kv), v, v_s), v_abs

    for name, kv_bits, shape, site, variant in (
            ("paged", 8, (128, 64), "two-pass", ""),
            ("paged", 4, (128, 64), "two-pass", ""),
            ("paged", 8, (128, 64), "softmax_in", ""),
            ("paged", 8, (128, 64), "two-pass", "holes+idle"),
            ("paged", 4, (587, 200), "two-pass", "split boundaries"),
            ("dense", 8, (128, 64), "two-pass", ""),
            ("dense", 4, (128, 64), "two-pass", ""),
            ("dense", 8, (587, 200), "two-pass", "split boundaries"),
            ("float", 16, (128, 64), "two-pass", ""),
            ("float", 32, (128, 64), "two-pass", ""),
            ("float", 16, (128, 64), "softmax_in", ""),
            ("float", 16, (128, 64), "two-pass", "holes+idle"),
            ("float", 32, (587, 200), "two-pass", "split boundaries")):
        # kv_bits: 8 / 4 int payloads, 16 / 32 K7's bf16 / f32 arenas
        s_len, window = shape
        site_name = {"two-pass": "two-pass softmax_out + zero-points",
                     "softmax_in": "softmax_in + zero-points"}[site]
        if name in ("paged", "float"):
            bs = 16
            nb = -(-s_len // bs)
            n_blocks = b * nb + 5
            table = torch.randperm(n_blocks, generator=gen, device=dev)[
                :b * nb].reshape(b, nb).to(torch.int32)
            q_pos = torch.full((b,), s_len - 1, device=dev,
                               dtype=torch.int32)
            if variant:       # unmapped runs, a short lane, an idle one
                _, bps = pad.plan_kv_splits(b, kv, nb, bs)
                table[0, bps:2 * bps] = -1
                table[1, nb - 1:] = -1
                q_pos[1], q_pos[3] = s_len // 3, -1
            valid = decode_valid(paged_positions_ref(
                table, q_pos, s_cap=s_len, block_size=bs), q_pos, window)
            meta = table.numel() * 4 + b * 4
        if name == "paged":
            ops_, v_abs = operands((n_blocks, bs), kv_bits)
            args = (*ops_, table, q_pos)
            kw = dict(s_cap=s_len, window=window, logit_softcap=50.0,
                      kv_bits=kv_bits, **site_kw(site_name))
            fn, plain = (pad.paged_int8_attend_decode_cuda,
                         pad.paged_int8_attend_decode_plain)
            case, kname = f"bs{bs} s_cap{s_len}", "K6"
        elif name == "float":
            fdt = torch.bfloat16 if kv_bits == 16 else torch.float32
            kf, vf = (torch.randn(n_blocks, bs, kv, hd, generator=gen,
                                  device=dev).to(fdt) for _ in range(2))
            q = torch.randn(b, kv, g, hd, generator=gen, device=dev) \
                * 0.3 / hd ** 0.5
            args = (q, kf, vf, table, q_pos)
            v_abs = float(vf.float().abs().max())
            kw = dict(s_cap=s_len, window=window, logit_softcap=50.0,
                      **site_kw(site_name))
            fn, plain = (pad.paged_attend_decode_cuda,
                         pad.paged_attend_decode_plain)
            case, kname = f"bs{bs} s_cap{s_len} {str(fdt)[6:]}", "K7"
        else:
            k_pos = torch.arange(s_len, device=dev, dtype=torch.int32
                                 ).repeat(b, 1)
            q_pos = torch.full((b,), s_len - 1, device=dev,
                               dtype=torch.int32)
            if variant:       # an empty split, a short lane, an idle one
                _, cps = iad.plan_dense_kv_splits(b, kv, s_len)
                k_pos[0, cps:2 * cps] = -1
                q_pos[1], q_pos[2] = s_len // 3, -1
            ops_, v_abs = operands((b, s_len), kv_bits)
            args = (*ops_, k_pos, q_pos)
            valid = decode_valid(k_pos, q_pos, window)
            kw = dict(window=window, logit_softcap=50.0, kv_bits=kv_bits,
                      **site_kw(site_name))
            fn, plain = (iad.int8_attend_decode_cuda,
                         iad.int8_attend_decode_plain)
            meta = b * s_len * 4 + b * 4
            case, kname = f"S{s_len}", "K5"
        f = fn(*args, **kw)
        f_plain = plain(*args, **kw)
        torch.cuda.synchronize()
        smo = kw["smo_quant"]
        f_bound = (1e-5 * float(f_plain.abs().max()) if smo is None
                   else float(smo[0]) * v_abs)
        attend_check(f, f_plain, None if smo is None else float(smo[0]),
                     v_abs)
        s_o = torch.tensor([float(f.abs().max()) / 100], device=dev)
        z_o = torch.round(ru(-5, 5, 1))
        ekw = dict(kw, out_scale=s_o, out_zp=z_o, **q8)
        got = fn(*args, **ekw)
        pair = pq.peg_quantize_cuda(f.reshape(b, -1), s_o, z_o, **q8)
        want = plain(*args, **ekw)
        torch.cuda.synchronize()
        label = (f"{kname}{'-kv4' if kv_bits == 4 else ''} B{b} KV{kv}xG{g} hd{hd} "
                 f"{case} w{window}{' ' + variant if variant else ''}, "
                 f"{site}")
        require(got.dtype == torch.int8 and torch.equal(got, pair),
                f"{label} emit: not K4's bytes on its f32 output")
        worst, _ = lsb_flips(got, want)
        require(worst <= 1 + f_bound / float(s_o),
                f"{label} emit: {worst} LSB off the plain emit")
        ms = time_ms(lambda: fn(*args, **ekw), flush)
        pair_ms = time_ms(lambda: pq.peg_quantize_cuda(
            fn(*args, **kw).reshape(b, -1), s_o, z_o, **q8), flush)
        p_ms = time_ms(lambda: plain(*args, **ekw), flush)
        n_valid = int(valid.sum())
        out_bytes = b * kv * g * hd + 8
        if name == "float":      # f32 queries, payload rows as stored
            nbytes = (n_valid * kv * 2 * hd * (kv_bits // 8) + meta
                      + b * kv * g * hd * 4 + out_bytes)
        else:
            payload = (hd if kv_bits == 4 else 2 * hd) + 8
            nbytes = (n_valid * kv * payload + meta + b * kv * g * (hd + 8)
                      + b * kv * 8 + out_bytes)
        macs = n_valid * kv * g * hd
        record(fn.__name__[:-len("_cuda")] + "_emit", label, float(worst),
               ms, p_ms, None, nbytes,
               [2 * macs, 2 * macs],
               [PEAK_F32_OPS_PER_S if name == "float"
                else PEAK_INT8_OPS_PER_S, PEAK_F32_OPS_PER_S],
               kv_bits in (8, 16) and s_len == 128 and not variant
               and site == "two-pass",
               f"  unfused f32 call + K4 {pair_ms:.4f} ms"
               + split_note(pad.plan_kv_splits(b, kv, nb, bs)[0]
                            if name != "dense" else
                            iad.plan_dense_kv_splits(b, kv, s_len)[0],
                            nbytes, ms))


def k6_split_cases(gen, ri, ru, site_kw, measure):
    """K6 and K6-kv4 at the split-KV kernel's boundaries, at the full
    width, two-pass: 37 blocks of 16 cells (s_cap 587, not a multiple of
    the block size; 10 splits of 4 blocks, the last of 1) and 52 blocks of
    8 (s_cap 413; 11 splits of 5, the last of 2), each with a hole that
    covers a whole split (lane 0), an unmapped tail (lane 1), an idle lane
    (lane 2) and a lane whose ring wrapped (lane 3)."""
    import torch
    from repro_torch.kernels import paged_attend_decode as pad
    from repro_torch.kernels.nibble import pack_nibbles
    from repro_torch.kernels.ref import decode_valid, paged_positions_ref
    dev = torch.device("cuda")
    b, kv, g, hd = 4, ATT_KV, ATT_G, ATT_HD
    site = "two-pass softmax_out + zero-points"
    for bs, s_cap, window in ((16, 587, 200), (8, 413, None)):
        nb = -(-s_cap // bs)
        splits, bps = pad.plan_kv_splits(b, kv, nb, bs)
        require(nb % bps != 0 and splits > 2,
                f"K6 split case bs{bs} s_cap{s_cap}: not a split boundary")
        n_blocks = b * nb + 5
        table = torch.randperm(n_blocks, generator=gen, device=dev)[
            :b * nb].reshape(b, nb).to(torch.int32)
        table[0, bps:2 * bps] = -1
        table[1, nb - 1:] = -1
        q_pos = torch.tensor([s_cap + 37, s_cap // 3, -1, 2 * s_cap - 1],
                             device=dev, dtype=torch.int32)
        valid = decode_valid(paged_positions_ref(
            table, q_pos, s_cap=s_cap, block_size=bs), q_pos, window)
        for kv_bits in (8, 4):
            if kv_bits == 4:
                k_a, v_a = (pack_nibbles(torch.randint(
                    -8, 8, (n_blocks, bs, kv, hd), generator=gen, device=dev,
                    dtype=torch.int8)) for _ in range(2))
                zk, zv = (torch.round(ru(-3, 3, b, kv)) for _ in range(2))
                v_s = ru(0.1, 0.5, n_blocks, bs, kv)
                v_abs = float((8 + zv.abs().max()) * v_s.max())
            else:
                k_a, v_a = ri(n_blocks, bs, kv, hd), ri(n_blocks, bs, kv, hd)
                zk, zv = (torch.round(ru(-20, 20, b, kv)) for _ in range(2))
                v_s = ru(0.01, 0.05, n_blocks, bs, kv)
                v_abs = float((v_a.float().abs().max() + zv.abs().max())
                              * v_s.max())
            args = (ri(b, kv, g, hd), ru(0.01, 0.03, b, kv, g) / 16,
                    torch.round(ru(-20, 20, b, kv, g)), zk, zv, k_a,
                    ru(0.01, 0.05, n_blocks, bs, kv), v_a, v_s, table, q_pos)
            kw = dict(s_cap=s_cap, window=window, logit_softcap=50.0,
                      kv_bits=kv_bits, **site_kw(site))
            name = "paged_int8_attend_decode" + ("_kv4" if kv_bits == 4
                                                 else "")
            measure(name, f"B{b} KV{kv}xG{g} hd{hd} bs{bs} s_cap{s_cap} "
                    f"w{window} split boundaries ({splits} x {bps} blocks, "
                    f"whole-split hole + idle lane), {site}",
                    pad.paged_int8_attend_decode_cuda,
                    pad.paged_int8_attend_decode_plain, args, kw, valid, kv,
                    g, hd, (hd if kv_bits == 4 else 2 * hd) + 8,
                    table.numel() * 4 + b * 4,
                    b * kv * g * (hd + 8) + b * kv * 8, v_abs, True, False,
                    splits)


def k7_split_cases(gen, site_kw, measure):
    """K7 at the split-KV kernel's boundaries, at the full width, two-pass,
    on bf16 arenas (32-cell stages) and f32 arenas (16-cell stages): the
    tables of ``k6_split_cases`` (37 blocks of 16, 52 of 8), with a hole
    over a whole split, an unmapped tail, an idle lane and a wrapped
    ring."""
    import torch
    from repro_torch.kernels import paged_attend_decode as pad
    from repro_torch.kernels.ref import decode_valid, paged_positions_ref
    dev = torch.device("cuda")
    b, kv, g, hd = 4, ATT_KV, ATT_G, ATT_HD
    site = "two-pass softmax_out + zero-points"
    for bs, s_cap, window in ((16, 587, 200), (8, 413, None)):
        nb = -(-s_cap // bs)
        splits, bps = pad.plan_kv_splits(b, kv, nb, bs)
        require(nb % bps != 0 and splits > 2,
                f"K7 split case bs{bs} s_cap{s_cap}: not a split boundary")
        n_blocks = b * nb + 5
        table = torch.randperm(n_blocks, generator=gen, device=dev)[
            :b * nb].reshape(b, nb).to(torch.int32)
        table[0, bps:2 * bps] = -1
        table[1, nb - 1:] = -1
        q_pos = torch.tensor([s_cap + 37, s_cap // 3, -1, 2 * s_cap - 1],
                             device=dev, dtype=torch.int32)
        valid = decode_valid(paged_positions_ref(
            table, q_pos, s_cap=s_cap, block_size=bs), q_pos, window)
        for fdt in (torch.bfloat16, torch.float32):
            q = torch.randn(b, kv, g, hd, generator=gen, device=dev) \
                * 0.3 / hd ** 0.5
            kf, vf = (torch.randn(n_blocks, bs, kv, hd, generator=gen,
                                  device=dev).to(fdt) for _ in range(2))
            el = kf.element_size()
            kw = dict(s_cap=s_cap, window=window, logit_softcap=50.0,
                      **site_kw(site))
            measure("paged_attend_decode",
                    f"B{b} KV{kv}xG{g} hd{hd} bs{bs} s_cap{s_cap} w{window} "
                    f"{str(fdt)[6:]} split boundaries ({splits} x {bps} "
                    f"blocks, whole-split hole + idle lane), two-pass "
                    f"softmax_out", pad.paged_attend_decode_cuda,
                    pad.paged_attend_decode_plain,
                    (q, kf, vf, table, q_pos), kw, valid, kv, g, hd,
                    2 * hd * el, table.numel() * 4 + b * 4,
                    b * kv * g * hd * 4, float(vf.float().abs().max()),
                    False, False, splits)


def k5_split_cases(gen, ri, ru, site_kw, measure):
    """K5 and K5-kv4 at the split-KV kernel's boundaries, at the full
    width, two-pass: 587 cells (10 splits of 64, the last of 11) with a
    window and 413 (13 splits of 32, the last of 29), each with an empty
    run over a whole split (lane 0), a short lane whose later cells are
    past its query (lane 1), an idle lane (lane 2) and a ring that wrapped
    (lane 3: slot c holds the newest position congruent to c)."""
    import torch
    from repro_torch.kernels import int8_attend_decode as iad
    from repro_torch.kernels.nibble import pack_nibbles
    from repro_torch.kernels.ref import decode_valid
    dev = torch.device("cuda")
    b, kv, g, hd = 4, ATT_KV, ATT_G, ATT_HD
    site = "two-pass softmax_out + zero-points"
    for s_len, window in ((587, 200), (413, None)):
        splits, cps = iad.plan_dense_kv_splits(b, kv, s_len)
        require(s_len % cps != 0 and splits > 2,
                f"K5 split case S{s_len}: not a split boundary")
        cells = torch.arange(s_len, device=dev, dtype=torch.int32)
        q_pos = torch.tensor([s_len - 1, s_len // 3, -1, 2 * s_len - 6],
                             device=dev, dtype=torch.int32)
        k_pos = cells.repeat(b, 1)
        k_pos[0, cps:2 * cps] = -1
        k_pos[3] = q_pos[3] - (q_pos[3] - cells) % s_len
        valid = decode_valid(k_pos, q_pos, window)
        for kv_bits in (8, 4):
            if kv_bits == 4:
                k_q, v_q = (pack_nibbles(torch.randint(
                    -8, 8, (b, s_len, kv, hd), generator=gen, device=dev,
                    dtype=torch.int8)) for _ in range(2))
                zk, zv = (torch.round(ru(-3, 3, b, kv)) for _ in range(2))
                v_s = ru(0.1, 0.5, b, s_len, kv)
                v_abs = float((8 + zv.abs().max()) * v_s.max())
            else:
                k_q, v_q = ri(b, s_len, kv, hd), ri(b, s_len, kv, hd)
                zk, zv = (torch.round(ru(-20, 20, b, kv)) for _ in range(2))
                v_s = ru(0.01, 0.05, b, s_len, kv)
                v_abs = float((v_q.float().abs().max() + zv.abs().max())
                              * v_s.max())
            args = (ri(b, kv, g, hd), ru(0.01, 0.03, b, kv, g) / 16,
                    torch.round(ru(-20, 20, b, kv, g)), zk, zv, k_q,
                    ru(0.01, 0.05, b, s_len, kv), v_q, v_s, k_pos, q_pos)
            kw = dict(window=window, logit_softcap=50.0, kv_bits=kv_bits,
                      **site_kw(site))
            name = "int8_attend_decode" + ("_kv4" if kv_bits == 4 else "")
            measure(name, f"B{b} KV{kv}xG{g} hd{hd} S{s_len} w{window} "
                    f"split boundaries ({splits} x {cps} cells, whole-split "
                    f"empty run + idle lane + wrapped ring), {site}",
                    iad.int8_attend_decode_cuda,
                    iad.int8_attend_decode_plain, args, kw, valid, kv, g, hd,
                    (hd if kv_bits == 4 else 2 * hd) + 8,
                    b * s_len * 4 + b * 4,
                    b * kv * g * (hd + 8) + b * kv * 8, v_abs, True, False,
                    splits)


def _counters():
    """{kernel name: (wrapper, launch-count attribute)}; a 4-bit variant
    is counted on its own attribute of the 8-bit kernel's wrapper, and so
    are K5's, K6's and K7's launches that emit int8 (either bit width)."""
    from repro_torch.kernels import fused_ln_quant as lnq
    from repro_torch.kernels import int8_attend_decode as iad
    from repro_torch.kernels import int8_matmul as imm
    from repro_torch.kernels import paged_attend_decode as pad
    from repro_torch.kernels import peg_quant as pq
    wrappers = {fn.__name__[:-len("_cuda")]: fn for fn in (
        lnq.rms_quantize_cuda, pq.peg_quantize_cuda, imm.int8_matmul_cuda,
        imm.int8_matmul_peg_cuda, iad.int8_attend_decode_cuda,
        pad.paged_int8_attend_decode_cuda, pad.paged_attend_decode_cuda,
        lnq.ln_quantize_cuda, lnq.rms_fake_quant_cuda,
        lnq.ln_fake_quant_cuda, pq.peg_fake_quant_cuda)}
    counters = {name: (fn, "launches") for name, fn in wrappers.items()}
    for name, attr in (("int8_matmul", "launches_w4"),
                       ("int8_matmul_peg", "launches_w4"),
                       ("int8_attend_decode", "launches_kv4"),
                       ("paged_int8_attend_decode", "launches_kv4"),
                       ("int8_attend_decode", "launches_emit"),
                       ("paged_int8_attend_decode", "launches_emit"),
                       ("paged_attend_decode", "launches_emit")):
        counters[f"{name}_{attr[len('launches_'):]}"] = (wrappers[name],
                                                         attr)
    assert set(counters) == set(KERNELS)
    return counters


def _timed_decode_steps(orig, report, profile_call=3):
    """Wrap ``make_decode_step`` so every decode call of the serve loop is
    timed (host clock around a synchronized call) and one steady-state
    call instead runs under ``torch.profiler`` (CUDA activity only: no host
    op recording), with the launch counters read around it; fills
    ``report``. The device idle share is the profiled step's kernel-busy
    time against the median unprofiled step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def build(cfg, **kw):
        step = orig(cfg, **kw)
        walls = report.setdefault("step_ms", [])

        def decode(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if len(walls) + 1 != profile_call:
                out = step(*args)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                return out
            before = {name: getattr(fn, attr)
                      for name, (fn, attr) in _counters().items()}
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = step(*args)
                torch.cuda.synchronize()
            report["profiled_wall_ms"] = (time.perf_counter() - t0) * 1e3
            report["step_launches"] = {
                name: getattr(fn, attr) - before[name]
                for name, (fn, attr) in _counters().items()}
            walls.append(None)
            report["prof"] = prof
            return out
        return decode
    return build


def _print_profile(tag, report):
    """Device busy time (union of kernel intervals), idle share and the
    kernels that take the most device time, for the profiled step."""
    walls = [w for w in report.get("step_ms", []) if w is not None]
    if walls:
        print(f"[{tag}] decode step wall (host clock, synchronized): median "
              f"{statistics.median(walls):.2f} ms over {len(walls)} steps")
    prof = report.get("prof")
    spans = []
    if prof is not None:
        for e in prof.events():
            if e.device_type.name == "CUDA" and e.time_range.end > \
                    e.time_range.start:
                spans.append((e.time_range.start, e.time_range.end))
    if not spans:
        print(f"[{tag}] profiled decode step: device time not measured "
              f"(the profiler recorded no kernels)")
        return
    spans.sort()
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    wall = statistics.median(walls) if walls else float("nan")
    print(f"[{tag}] profiled decode step: device busy {busy / 1e3:.2f} ms "
          f"({len(spans)} kernels) against a {wall:.2f} ms step: device "
          f"idle {max(0.0, 1 - busy / 1e3 / wall):.1%} (wall under the "
          f"profiler {report['profiled_wall_ms']:.2f} ms)")
    by_name = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    # the eight costliest kernels, then every hand-written one of the port
    for i, (name, (t, n)) in enumerate(ranked):
        if i < 8 or re.search(PORT_KERNELS, name):
            print(f"[{tag}]   {t / 1e3:8.3f} ms  x{n:<4d} "
                  f"({t / n:.1f} us each) {name[:90]}")


def serve_phase(tag, argv, must_launch, step_emits=None, per_call=None):
    """Drive ``repro_torch.launch.serve.main`` once with every launch count
    set to 0 just before and read just after; returns (counts, rel diff of
    the integer path vs fake-quant, stats, the launcher's output). Decode
    steps are timed and one is profiled (see _timed_decode_steps); with
    ``step_emits`` (a counter name) the profiled decode step must launch
    that fused emit and no K4. ``per_call`` (a counter name and a pattern
    of kernel names) prints the device time those kernels took in the
    profiled step per call of that counter's wrapper."""
    import torch
    from repro_torch.launch import serve
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):   # pay CUPTI set-up
        (torch.ones(1, device="cuda") + 1).cpu()        # outside the run
    report = {}
    orig_make = serve.make_decode_step
    serve.make_decode_step = _timed_decode_steps(orig_make, report)
    counters = _counters()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            stats = serve.main(argv)
    finally:
        serve.make_decode_step = orig_make
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {name: getattr(fn, attr)
              for name, (fn, attr) in counters.items()}
    for line in out.getvalue().splitlines():
        print(f"[{tag}] {line}")
    launched = {name: n for name, n in counts.items() if n}
    print(f"[{tag}] kernel launches {launched}; phase {secs:.1f} s, peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} "
          f"GiB")
    _print_profile(tag, report)
    step = {name: n for name, n in report.get("step_launches", {}).items()
            if n}
    print(f"[{tag}] kernel launches in the profiled decode step {step}")
    for name in must_launch:
        require(counts[name] > 0, f"{tag}: {name} was never launched")
    if step_emits is not None:
        require(step.get(step_emits, 0) > 0 and "peg_quantize" not in step,
                f"{tag}: the profiled decode step launched {step}, not "
                f"{step_emits} and no peg_quantize")
    if per_call is not None and report.get("prof") is not None:
        name, pattern = per_call
        spans = [e.time_range.elapsed_us() for e in report["prof"].events()
                 if e.device_type.name == "CUDA"
                 and re.search(pattern, e.name)]
        calls = step.get(name, 0)
        print(f"[{tag}] {name} in the profiled decode step: "
              f"{sum(spans) / 1e3:.3f} ms in {len(spans)} kernels over "
              f"{calls} calls"
              + (f", {sum(spans) / calls:.1f} us a call" if calls else ""))
    m = re.search(r"logits diff (\S+) \(rel (\S+)%\)", out.getvalue())
    require(m is not None, f"{tag}: no [deploy-int8] parity line")
    rel = float(m.group(2)) / 100
    requests, new_tokens = (int(argv[argv.index(f) + 1])
                            for f in ("--requests", "--new-tokens"))
    require(stats.tokens_generated == requests * new_tokens,
            f"{tag}: {stats.tokens_generated} tokens generated, expected "
            f"{requests * new_tokens}")
    return counts, rel, stats, out.getvalue()


def entry_point_phase():
    """Phase 11. K8-K10 serve no model here (no LayerNorm config is ported,
    and the reference calls its fake-quant kernels only from its tests and
    its kernel bench), so their path is their public entry points: driven
    as the reference's bench drives them (``benchmarks/kernel_bench.py``:
    4096 x 4096 f32, PEG with 8 groups at (0.05, 128), LayerNorm per-tensor),
    and K8 the way a LayerNorm model's deploy path reaches it, through
    ``deploy.norm_quantize("layernorm", ...)`` with a PEG permutation.
    Counts are set to 0 just before and read just after; the outputs must
    be finite and of their inputs' shapes."""
    import torch
    from repro_torch.core import deploy
    from repro_torch.kernels import ops
    counters = {name: counter for name, counter in _counters().items()
                if name in ("ln_quantize", "rms_fake_quant", "ln_fake_quant",
                            "peg_fake_quant")}
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    n = 4096
    x = torch.randn(n, n, generator=gen, device=dev)
    ones = torch.ones(n, device=dev)
    zeros = torch.zeros(n, device=dev)
    outs = [ops.peg_fake_quant(x, torch.full((8,), 0.05, device=dev),
                               torch.full((8,), 128.0, device=dev)),
            ops.ln_fake_quant(x, ones, zeros, 0.05, 128.0),
            ops.rms_fake_quant(x, zeros, 0.05, 128.0)]
    h = torch.randn(B, T, D, generator=gen, device=dev).to(torch.bfloat16)
    aq = deploy.ActQuant(
        scales=torch.full((4,), 0.03, device=dev),
        zps=torch.full((4,), -3.0, device=dev), qmin=-128, qmax=127,
        perm=torch.randperm(D, generator=gen, device=dev))
    norm = {"g": 1 + 0.1 * torch.randn(D, generator=gen, device=dev),
            "b": 0.1 * torch.randn(D, generator=gen, device=dev)}
    qt = deploy.norm_quantize("layernorm", norm, h, aq)
    torch.cuda.synchronize()
    require(all(o.shape == x.shape and bool(torch.isfinite(o).all())
                for o in outs), "entry points: bad fake-quant output")
    require(qt.q.shape == h.shape and qt.q.dtype == torch.int8,
            "entry points: bad norm_quantize output")
    counts = {name: getattr(fn, attr)
              for name, (fn, attr) in counters.items()}
    print(f"[entry-points] kernel launches {counts}")
    for name, count in counts.items():
        require(count > 0, f"entry points: {name} was never launched")
    return counts


def kv_gap(tag, out, bits=8):
    """The [kv-int8] / [kv-int4] gap against the bf16 (f32) cache."""
    m = re.search(rf"\[kv-int{bits}\] max rel logits diff .*: (\S+)%", out)
    require(m is not None, f"{tag}: no [kv-int{bits}] line")
    return float(m.group(1)) / 100


def kv4_lines(tag, out):
    """The 4-bit phases' [kv-int4] and packed-weight lines, printed as
    they are (kv4 drift is reported, not bounded, as in the reference);
    returns the int4 (q4) payload count."""
    drift = re.search(r"^\[kv-int4\] int4 vs int8 cache drift.*$", out,
                      re.M)
    require(drift is not None, f"{tag}: no [kv-int4] drift line")
    m = re.search(r"packed weights: (\d+) int8 and (\d+) int4 \(q4\) "
                  r"payloads, (\S+) MiB", out)
    require(m is not None, f"{tag}: no packed-weights line")
    print(f"[{tag}] {m.group(2)} q4 payloads ({m.group(1)} int8), "
          f"{m.group(3)} MiB of packed weights; {drift.group(0)}")
    return int(m.group(2))


def require_parity(tag, out, n):
    oks = re.findall(r"^\[parity\] OK", out, re.M)
    require(len(oks) == n, f"{tag}: {len(oks)} of {n} [parity] OK lines")


def quick_argv(kv_bits, *extra):
    """The README quickstart's serving flags (``--kv-bits kv_bits``)."""
    return ["--arch", "gemma2-2b", "--quantize", "--deploy-int8",
            "--kv-bits", kv_bits, "--scheduler", "continuous", "--paged-kv",
            "--prefill-chunk", "8", "--requests", "6", "--prompt-len", "24",
            "--new-tokens", "6", "--batch-slots", "4", *extra]


FULL_QUICK = ("--block-size", "16", "--max-len", "128")
W4 = ("--weight-bits", "4")


@contextlib.contextmanager
def _bisect_blocks(tag, threshold=1e-4):
    """Layer-by-layer bisect of the launcher's ``[deploy-int8]`` forward
    (the fake-quant forward, then the integer one, on the same tokens):
    every block of the integer path runs once more on the fake-quant
    path's input of that block, and its output (and its attention
    output) is held against the fake-quant block's. Prints per layer the
    accumulated gap (integer forward against fake-quant forward) and the
    local one (one integer block on the fake-quant input), each as max
    |difference| / max |fake-quant value|; how many local outputs differ,
    and by how many steps of the grid they were last quantized on
    (``ctx_out`` for the attention, ``residual_ffn`` for the block: a
    value that sat on a rounding tie moves by one step); and the first
    layer whose local gap exceeds ``threshold``."""
    from repro_torch.core import Mode
    from repro_torch.models import transformer as tfm
    orig_forward, orig_block = tfm.forward, tfm.block_apply
    orig_attn = tfm.attention_block
    rec = {"mode": None, Mode.APPLY: [], Mode.DEPLOY: [], "attn": None}

    def rel(want, got):
        want, got = want.float(), got.float()
        return float((want - got).abs().max() / (want.abs().max() + 1e-30))

    def attention_block(*args, **kw):
        out = orig_attn(*args, **kw)
        rec["attn"] = out[0]
        return out

    def block_apply(cfg, kind, p, x, positions, **kw):
        out = orig_block(cfg, kind, p, x, positions, **kw)
        if rec["mode"] is not None:
            rec[rec["mode"]].append(dict(kind=kind, p=p, x=x, pos=positions,
                                         kw=kw, out=out[0],
                                         attn=rec["attn"]))
        return out

    def forward(cfg, params, tokens, *, ctx=None, cache=None, **kw):
        mode = getattr(ctx, "mode", None)
        active = cache is None and mode in (Mode.APPLY, Mode.DEPLOY) \
            and not rec[mode]
        rec["mode"] = mode if active else None
        try:
            out = orig_forward(cfg, params, tokens, ctx=ctx, cache=cache,
                               **kw)
        finally:
            rec["mode"] = None
        if active and mode == Mode.DEPLOY:
            report(cfg)
        return out

    def steps(want, got, ctx, site):
        """(elements that differ, the largest difference in steps of the
        grid of ``site``: per tensor, or per column through its PEG
        groups)."""
        d = (want.float() - got.float()).abs()
        qp = ctx.act_state[site]
        step = qp.scale.float().reshape(-1)
        if qp.group_index is not None:
            step = step[qp.group_index.long()]
        return int((d > 0).sum()), float((d / step).max())

    def report(cfg):
        first = None
        for i, (ref, got) in enumerate(zip(rec[Mode.APPLY],
                                           rec[Mode.DEPLOY])):
            local, _ = orig_block(cfg, got["kind"], got["p"], ref["x"],
                                  ref["pos"], **got["kw"])
            gaps = (rel(ref["out"], got["out"]), rel(ref["out"], local),
                    rel(ref["attn"], rec["attn"]))
            ctx, pre = got["kw"]["ctx"], got["kw"]["prefix"]
            n_att, s_att = steps(ref["attn"], rec["attn"], ctx,
                                 f"{pre}/attn/ctx_out")
            n_blk, s_blk = steps(ref["out"], local, ctx,
                                 f"{pre}/residual_ffn")
            print(f"[{tag}] bisect layer {i}: accumulated {gaps[0]:.3e}, "
                  f"local {gaps[1]:.3e} (its attention {gaps[2]:.3e}; "
                  f"{n_att} of {rec['attn'].numel()} attention outputs "
                  f"differ, by at most {s_att:.2f} ctx_out steps; {n_blk} "
                  f"block outputs, by at most {s_blk:.2f} residual steps; "
                  f"input max|x| {float(ref['x'].abs().max()):.3e})")
            if first is None and gaps[1] > threshold:
                first = (i, gaps)
        print(f"[{tag}] bisect: " + (
            f"no layer's local gap exceeds {threshold:.0e}" if first is None
            else f"first layer with a local gap above {threshold:.0e}: "
                 f"{first[0]} (local {first[1][1]:.3e}, its attention "
                 f"{first[1][2]:.3e})"))

    tfm.forward, tfm.block_apply = forward, block_apply
    tfm.attention_block = attention_block
    try:
        yield
    finally:
        tfm.forward, tfm.block_apply = orig_forward, orig_block
        tfm.attention_block = orig_attn


def f32_parity_phase(runs=("w8-kv8", "w4-kv4")):
    """``--f32-parity``: the full-width quickstart's startup checks
    (``[deploy-int8]``, ``[kv-int8]`` / ``[kv-int4]``) and ``--parity``
    once with f32 params (about 10.5 GB) at W8 / kv8 and W4 / kv4, with a
    layer-by-layer bisect of the ``[deploy-int8]`` forward
    (:func:`_bisect_blocks`). At bf16 the fake-quant side of those checks
    rounds every site to bf16; here both sides compute in f32, so a gap
    left is the integer path's own. The gaps and the ``--parity`` verdict
    are printed, not bounded (a full-width measurement, like the bf16
    gaps of the main run): a ``[parity] FAIL`` ends that run's parity
    reruns and is printed as its result. Returns {run: the launcher's
    output}."""
    import torch
    from repro_torch.launch import serve
    argv = {"w8-kv8": quick_argv("8", *FULL_QUICK, "--parity"),
            "w4-kv4": quick_argv("4", *FULL_QUICK, *W4, "--parity")}
    outs = {}
    for run in runs:
        tag = f"f32-{run}"
        out = io.StringIO()
        t0 = time.perf_counter()
        try:
            with _bisect_blocks(tag), contextlib.redirect_stdout(out):
                try:
                    serve.main(argv[run], dtype=torch.float32)
                except SystemExit as e:       # the --parity verdict only
                    if not str(e.code).startswith("[parity] FAIL"):
                        raise
                    print(e.code)
        finally:
            for line in out.getvalue().splitlines():
                print(f"[{tag}] {line}" if not line.startswith(f"[{tag}]")
                      else line)
            print(f"[{tag}] {time.perf_counter() - t0:.1f} s, peak device "
                  f"memory {torch.cuda.max_memory_allocated() / 2**30:.1f} "
                  f"GiB")
            torch.cuda.empty_cache()
        outs[run] = out.getvalue()
    return outs


def ptxas_report():
    """``--ptxas``: compile the split and cluster kernels' sources once more
    with ``-Xptxas -v`` (into build/ptxas) and print one line per kernel
    instantiation: its registers, static shared memory (the cp.async rings
    of ``int8_matmul.cu`` and the split-KV stages of K5-K7 are dynamic)
    and spills."""
    from repro_torch.kernels import _build
    out = _build.BUILD_ROOT / "ptxas"
    out.mkdir(parents=True, exist_ok=True)
    procs = [(name, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(out / f"lib{name}.so"), str(_build.CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name in ("norm_quant", "int8_matmul", "int8_attend_decode",
                     "paged_attend_decode")]
    for name, proc in procs:
        log, _ = proc.communicate()
        require(proc.returncode == 0, f"nvcc failed on {name}.cu:\n{log}")
        entry, spills = "?", ""
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                spills = f"spills {m.group(1)}/{m.group(2)} B"
            m = re.search(r"Used (\d+) registers", line)
            if m:
                smem = re.search(r"(\d+) bytes smem", line)
                print(f"[ptxas] {name}: {_demangle(entry)}: {m.group(1)} "
                      f"registers, {smem.group(1) if smem else 0} B static "
                      f"smem, {spills}")


def _demangle(symbol):
    """A kernel's C++ name (``c++filt``, where the toolchain has it)."""
    try:
        return subprocess.run(["c++filt", symbol], capture_output=True,
                              text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return symbol


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the port's sources are missing next to this "
              f"script ({e})", file=sys.stderr)
        return 2
    if "--ptxas" in sys.argv[1:]:
        ptxas_report()
    if "--f32-parity" in sys.argv[1:]:
        f32_parity_phase()
    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"[build] {len(_build.SOURCES)} kernel libraries built in "
          f"{secs:.1f} s ({_build.build_dir()})")
    records = kernel_phase()
    print(f"[kernels] phase done at {time.perf_counter() - t0:.1f} s")

    serve_argv = ["--arch", "gemma2-2b", "--quantize", "--deploy-int8",
                  "--scheduler", "static", "--kv-bits", "16"]
    launches = {name: 0 for name in KERNELS}

    def add(counts):
        for name, n in counts.items():
            launches[name] += n
        torch.cuda.empty_cache()

    full, full_rel, _, _ = serve_phase(
        "full", serve_argv + ["--requests", "4", "--prompt-len", "16",
                              "--new-tokens", "8", "--batch-slots", "4",
                              "--max-len", "128"],
        ("rms_quantize", "int8_matmul", "peg_quantize"))
    add(full)
    reduced, red_rel, _, _ = serve_phase(
        "reduced", serve_argv + ["--reduced", "--requests", "6",
                                 "--prompt-len", "24", "--new-tokens", "6",
                                 "--batch-slots", "4", "--max-len", "64"],
        ("rms_quantize", "peg_quantize", "int8_matmul", "int8_matmul_peg"))
    add(reduced)

    # The README quickstart's serving flags. At full width without
    # --parity: the full-width FFN serves fake-quant through torch.matmul,
    # whose rounding may change with the number of rows, so two schedulers
    # that batch the same request differently need not emit the same greedy
    # tokens there (in bf16, and in f32 too: see f32_parity_phase).
    reduced_quick = ("--reduced", "--block-size", "8", "--max-len", "64",
                     "--parity")
    fq, fq_rel, fq_stats, fq_out = serve_phase(
        "full-quickstart", quick_argv("8", *FULL_QUICK),
        ("rms_quantize", "int8_matmul", "peg_quantize", "int8_attend_decode",
         "paged_int8_attend_decode", "int8_attend_decode_emit",
         "paged_int8_attend_decode_emit"), "paged_int8_attend_decode_emit")
    add(fq)
    fq_kv = kv_gap("full-quickstart", fq_out)
    rq, rq_rel, rq_stats, rq_out = serve_phase(
        "reduced-quickstart", quick_argv("8", *reduced_quick),
        ("rms_quantize", "peg_quantize", "int8_matmul", "int8_matmul_peg",
         "int8_attend_decode", "paged_int8_attend_decode",
         "int8_attend_decode_emit", "paged_int8_attend_decode_emit"),
        "paged_int8_attend_decode_emit")
    add(rq)
    rq_kv = kv_gap("reduced-quickstart", rq_out)
    require(rq_kv <= 1e-4, f"reduced-quickstart: [kv-int8] gap "
            f"{rq_kv:.4%} > 1e-4")
    require_parity("reduced-quickstart", rq_out, 3)
    counts = (rq_stats.tokens_generated, rq_stats.decode_steps,
              rq_stats.prefill_calls, rq_stats.blocks_in_use,
              rq_stats.chunk_steps)
    require(counts == (36, 10, 6, 16, 6) and "blocks 16/32" in rq_out,
            f"reduced-quickstart: serve counts {counts} are not the "
            f"reference's (36, 10, 6, 16, 6)")
    r16, r16_rel, _, r16_out = serve_phase(
        "reduced-paged-kv16", quick_argv("16", *reduced_quick),
        ("paged_attend_decode", "paged_attend_decode_emit"),
        "paged_attend_decode_emit")
    add(r16)
    require_parity("reduced-paged-kv16", r16_out, 3)
    # K7 at full width: the quickstart's flags with a bf16 paged cache
    f16, f16_rel, f16_stats, _ = serve_phase(
        "full-quickstart-kv16", quick_argv("16", *FULL_QUICK),
        ("rms_quantize", "int8_matmul", "peg_quantize",
         "paged_attend_decode", "paged_attend_decode_emit"),
        "paged_attend_decode_emit",
        ("paged_attend_decode",
         r"split_attend_kernel(<__nv_bfloat16|<float|I13__nv_bfloat16|If)"))
    add(f16)
    print(f"[full-quickstart-kv16] peak kv-cache {f16_stats.cache_bytes} "
          f"bytes ({f16_stats.blocks_in_use} blocks) against "
          f"{fq_stats.cache_bytes} bytes ({fq_stats.blocks_in_use} blocks) "
          f"at kv-bits 8")

    # The 4-bit deploy path: int4 weights (q4) and int4 KV caches. At full
    # width the attention projections pack as q4 (K3-w4); the FFN keeps the
    # reference's fake-quant rule (non-uniform PEG groups), so K2-w4 runs
    # at the reduced width. kv4 parity is a match rate, not asserted.
    f4, f4_rel, f4_stats, f4_out = serve_phase(
        "full-quickstart-4bit", quick_argv("4", *FULL_QUICK, *W4),
        ("rms_quantize", "int8_matmul_w4", "peg_quantize",
         "int8_attend_decode_kv4", "paged_int8_attend_decode_kv4",
         "int8_attend_decode_emit", "paged_int8_attend_decode_emit"),
        "paged_int8_attend_decode_emit")
    add(f4)
    f4_kv = kv_gap("full-quickstart-4bit", f4_out, 4)
    require(kv4_lines("full-quickstart-4bit", f4_out) > 0,
            "full-quickstart-4bit: no q4 payloads")
    print(f"[full-quickstart-4bit] peak kv-cache {f4_stats.cache_bytes} "
          f"bytes ({f4_stats.blocks_in_use} blocks) against "
          f"{fq_stats.cache_bytes} bytes ({fq_stats.blocks_in_use} blocks) "
          f"at kv-bits 8")
    r4, r4_rel, r4_stats, r4_out = serve_phase(
        "reduced-quickstart-4bit", quick_argv("4", *reduced_quick, *W4),
        ("rms_quantize", "int8_matmul_w4", "int8_matmul_peg_w4",
         "peg_quantize", "int8_attend_decode_kv4",
         "paged_int8_attend_decode_kv4", "int8_attend_decode_emit",
         "paged_int8_attend_decode_emit"), "paged_int8_attend_decode_emit")
    add(r4)
    r4_kv = kv_gap("reduced-quickstart-4bit", r4_out, 4)
    kv4_lines("reduced-quickstart-4bit", r4_out)
    counts = (r4_stats.tokens_generated, r4_stats.decode_steps,
              r4_stats.prefill_calls, r4_stats.blocks_in_use,
              r4_stats.chunk_steps)
    require(counts == (36, 10, 6, 16, 6) and "blocks 16/32" in r4_out,
            f"reduced-quickstart-4bit: serve counts {counts} are not the "
            f"reference's (36, 10, 6, 16, 6)")
    rates = re.findall(r"^\[parity\] (.+?): \d+/36 greedy tokens match",
                       r4_out, re.M)
    require(rates == ["continuous vs static schedulers",
                      "chunked vs unchunked prefill",
                      "paged vs dense caches",
                      "int4 vs int8 KV cache drift"],
            f"reduced-quickstart-4bit: parity lines {rates}")
    # The reduced run holds the integer path to the fake-quant path it
    # replaces. At full width the fake-quant path runs in bf16 (bf16 params:
    # fake-quantized values are rounded to bf16 and the matmuls emit bf16)
    # while the integer path accumulates exactly and emits f32, so there the
    # gap is printed, not bounded.
    print(f"[full] integer vs fake-quant (bf16) logits: rel {full_rel:.4%}")
    print(f"[full-quickstart] integer vs fake-quant (bf16) logits: rel "
          f"{fq_rel:.4%}; int8 vs bf16 KV cache: rel {fq_kv:.4%}")
    print(f"[full-quickstart-kv16] integer vs fake-quant (bf16) logits: rel "
          f"{f16_rel:.4%}")
    print(f"[full-quickstart-4bit] integer vs fake-quant (bf16) logits: rel "
          f"{f4_rel:.4%}; int4 vs bf16 KV cache: rel {f4_kv:.4%}")
    print(f"[reduced-quickstart-4bit] int4 vs f32 KV cache: rel "
          f"{r4_kv:.4%} (printed, not bounded)")
    for tag, rel in (("reduced", red_rel), ("reduced-quickstart", rq_rel),
                     ("reduced-paged-kv16", r16_rel),
                     ("reduced-quickstart-4bit", r4_rel)):
        require(rel <= 1e-4, f"{tag}: integer path differs from "
                f"fake-quant by {rel:.4%} of max|logits|")
        print(f"[{tag}] integer vs fake-quant logits: rel {rel:.4%} "
              f"(bound 1e-4)")
    print(f"[reduced-quickstart] int8 vs f32 KV cache: rel {rq_kv:.4%} "
          f"(bound 1e-4)")
    for name, count in entry_point_phase().items():
        launches[name] += count
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        rec = records[name]
        kernels.append({
            "name": name, "route": "cuda", "source": _CSRC + source,
            "replaces": _TPU + replaces,
            "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
