#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit before the last line):

1. build   — compile every CUDA kernel from ``src/repro_torch/csrc``.
2. kernels — hold each kernel against its plain PyTorch version on the card
             at the full-width gemma2-2b shapes of the serving path (B=4,
             T=16), with the tolerances of the CPU parity tests, and time
             kernel, plain version and, where one exists, a PyTorch library
             call computing the same function (CUDA events, L2 flushed
             before every launch).
3. full    — serve gemma2-2b at full width (26 layers, d 2304, bf16) through
             ``repro_torch.launch.serve.main`` with W8A8 PTQ + the integer
             deploy path, static scheduler; the K1/K3/K4 launch counters
             must move.
4. reduced — the README-sized run (``--reduced``): all four counters must
             move, including ``int8_matmul_peg``, which the full-width run
             does not reach (its FFN groups are not uniform, so that FFN
             serves on the fake-quant path).

In both serving phases every request must get its tokens. The reduced run's
integer-path logits must match the fake-quant path they replace within 1e-4
of max|logits| (the launcher's ``[deploy-int8]`` line); the full-width gap
is printed only, since there the fake-quant path computes in bf16.

Prints the card (``nvidia-smi`` name and power limit), one JSON line with
every kernel's numbers, and as the last line
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
SOURCE = {"rms_quantize": "src/repro_torch/csrc/norm_quant.cu",
          "peg_quantize": "src/repro_torch/csrc/peg_quant.cu",
          "int8_matmul": "src/repro_torch/csrc/int8_matmul.cu",
          "int8_matmul_peg": "src/repro_torch/csrc/int8_matmul.cu"}
REPLACES = {"rms_quantize": "src/repro/kernels/fused_ln_quant.py:111",
            "peg_quantize": "src/repro/kernels/peg_quant.py:67",
            "int8_matmul": "src/repro/kernels/int8_matmul.py:121",
            "int8_matmul_peg": "src/repro/kernels/int8_matmul.py:245"}


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def bound_ms(nbytes, ops, ops_rate):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / ops_rate
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
               representative):
        b_ms, by = bound_ms(nbytes, ops, rate)
        print(f"[kernels] {name} {case}: max_abs_err {err:.3e}  kernel "
              f"{ms:.4f} ms  plain {plain_ms:.4f} ms  library "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}  bound "
              f"{b_ms:.4f} ms ({by})")
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
                   rows == B * T and g == 1)

    # K4 peg_quantize: the wo input (B*T and B rows, 2048 wide, f32)
    for rows in (B * T, B):
        x = randn(rows, Q_OUT)
        s = uniform(1, 0.01, 0.03)
        z = torch.round(uniform(1, -10, 10))
        kw = dict(qmin=-128, qmax=127)
        got = pq.peg_quantize_cuda(x, s, z, **kw)
        want = pq.peg_quantize_plain(x, s, z, **kw)
        require(torch.equal(got, want),
                f"peg_quantize ({rows},{Q_OUT}) not bit-exact")
        ms = time_ms(lambda: pq.peg_quantize_cuda(x, s, z, **kw), flush)
        p_ms = time_ms(lambda: pq.peg_quantize_plain(x, s, z, **kw), flush)
        record("peg_quantize", f"x ({rows},{Q_OUT}) f32 G=1", 0.0, ms, p_ms,
               None, rows * Q_OUT * 5 + 8, 4 * rows * Q_OUT,
               PEAK_F32_OPS_PER_S, rows == B * T)

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
            lib_ms = None
            if m > 16:      # torch._int_mm needs more than 16 rows
                s_prod = s_a * s_w

                def library():
                    acc = torch._int_mm(a, w).float()
                    return (acc - z_a * cs.float()) * s_prod
                lib_err = float((library() - want).abs().max())
                require(lib_err <= 1e-5 * float(want.abs().max()),
                        f"library yardstick disagrees: {lib_err}")
                lib_ms = time_ms(library, flush)
            record("int8_matmul", f"({m},{k})x({k},{n}) f32 out", err, ms,
                   p_ms, lib_ms, m * k + k * n + n * 4 + m * n * 4,
                   2 * m * n * k, PEAK_INT8_OPS_PER_S,
                   m == B * T and (k, n) == (D, Q_OUT))

    # K2 int8_matmul_peg: w_up (f32 out) and w_gate (gelu * up -> int8),
    # 576-wide (G=4) and 384-wide (G=6) groups
    for g in (4, 6):
        for m in (B * T, B):
            a = randint8(m, D)
            w = randint8(D, FF, lo=-127)
            cs = w_colsum_groups(w, g)
            sg = uniform(g, 0.01, 0.05)
            zg = torch.round(uniform(g, -20, 20))
            s_w = uniform(1, 0.001, 0.01)
            up = randn(m, FF)
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
                nbytes = (m * D + D * FF + g * FF * 4 + 2 * g * 4 +
                          (m * FF * (4 + 1) if requant else m * FF * 4))
                out = "gelu*mul->int8" if requant else "f32 out"
                record("int8_matmul_peg", f"({m},{D})x({D},{FF}) G={g} {out}",
                       err, ms, p_ms, None, nbytes, 2 * m * FF * D,
                       PEAK_INT8_OPS_PER_S,
                       m == B * T and g == 4 and not requant)
    return records


def _counters():
    from repro_torch.kernels import fused_ln_quant as lnq
    from repro_torch.kernels import int8_matmul as imm
    from repro_torch.kernels import peg_quant as pq
    return {"rms_quantize": lnq.rms_quantize_cuda,
            "peg_quantize": pq.peg_quantize_cuda,
            "int8_matmul": imm.int8_matmul_cuda,
            "int8_matmul_peg": imm.int8_matmul_peg_cuda}


def _timed_decode_steps(orig, report, profile_call=3):
    """Wrap ``make_decode_step`` so every decode call of the serve loop is
    timed (host clock around a synchronized call) and one steady-state
    call instead runs under ``torch.profiler`` (CUDA activity only: no host
    op recording); fills ``report``. The device idle share is the profiled
    step's kernel-busy time against the median unprofiled step."""
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
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = step(*args)
                torch.cuda.synchronize()
            report["profiled_wall_ms"] = (time.perf_counter() - t0) * 1e3
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
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"[{tag}]   {t / 1e3:8.3f} ms  x{n:<4d} {name[:90]}")


def serve_phase(tag, argv, must_launch):
    """Drive ``repro_torch.launch.serve.main`` once with every launch count
    set to 0 just before and read just after; returns (counts, rel diff of
    the integer path vs fake-quant, stats). Decode steps are timed and one
    is profiled (see _timed_decode_steps)."""
    import torch
    from repro_torch.launch import serve
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):   # pay CUPTI set-up
        (torch.ones(1, device="cuda") + 1).cpu()        # outside the run
    report = {}
    orig_make = serve.make_decode_step
    serve.make_decode_step = _timed_decode_steps(orig_make, report)
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            stats = serve.main(argv)
    finally:
        serve.make_decode_step = orig_make
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in counters.items()}
    for line in out.getvalue().splitlines():
        print(f"[{tag}] {line}")
    print(f"[{tag}] kernel launches {counts}; phase {secs:.1f} s, peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} "
          f"GiB")
    _print_profile(tag, report)
    for name in must_launch:
        require(counts[name] > 0, f"{tag}: {name} was never launched")
    m = re.search(r"logits diff (\S+) \(rel (\S+)%\)", out.getvalue())
    require(m is not None, f"{tag}: no [deploy-int8] parity line")
    rel = float(m.group(2)) / 100
    requests, new_tokens = (int(argv[argv.index(f) + 1])
                            for f in ("--requests", "--new-tokens"))
    require(stats.tokens_generated == requests * new_tokens,
            f"{tag}: {stats.tokens_generated} tokens generated, expected "
            f"{requests * new_tokens}")
    return counts, rel, stats


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
    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"[build] {len(_build.SOURCES)} kernel libraries built in "
          f"{secs:.1f} s ({_build.build_dir()})")
    records = kernel_phase()
    print(f"[kernels] phase done at {time.perf_counter() - t0:.1f} s")

    serve_argv = ["--arch", "gemma2-2b", "--quantize", "--deploy-int8",
                  "--scheduler", "static", "--kv-bits", "16"]
    full, full_rel, _ = serve_phase(
        "full", serve_argv + ["--requests", "4", "--prompt-len", "16",
                              "--new-tokens", "8", "--batch-slots", "4",
                              "--max-len", "128"],
        ("rms_quantize", "int8_matmul", "peg_quantize"))
    torch.cuda.empty_cache()
    reduced, red_rel, _ = serve_phase(
        "reduced", serve_argv + ["--reduced", "--requests", "6",
                                 "--prompt-len", "24", "--new-tokens", "6",
                                 "--batch-slots", "4", "--max-len", "64"],
        tuple(SOURCE))
    # The reduced run holds the integer path to the fake-quant path it
    # replaces. At full width the fake-quant path runs in bf16 (bf16 params:
    # fake-quantized values are rounded to bf16 and the matmuls emit bf16)
    # while the integer path accumulates exactly and emits f32, so there the
    # gap is printed, not bounded.
    print(f"[full] integer vs fake-quant (bf16) logits: rel {full_rel:.4%}")
    require(red_rel <= 1e-4, f"reduced: integer path differs from "
            f"fake-quant by {red_rel:.4%} of max|logits|")
    print(f"[reduced] integer vs fake-quant logits: rel {red_rel:.4%} "
          f"(bound 1e-4)")
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")

    kernels = []
    for name in SOURCE:
        rec = records[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name],
            "launches": full[name] + reduced[name],
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
