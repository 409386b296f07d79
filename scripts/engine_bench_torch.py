#!/usr/bin/env python3
"""Engine-API microbenchmark of the PyTorch port: per-call times of the
decomposed triad — ``prefill`` (the prompt pass on the scratch cache and
the payload copy, with its first-token read-back), ``insert`` (landing a
payload in a lane) and ``generate`` (one batched decode step with its
greedy read-back) — on gemma2-2b with every lane occupied: the steady
state of a saturated server.

Before any row is written the bench asserts that ``serve_engine`` emits the
continuous Scheduler's greedy tokens on the same requests, and that every
engine step saw one input shape signature. Each timed call is bracketed by
device synchronisations (host clock), so a time is the call's whole cost
to its caller; the medians and means are written.

    PYTHONPATH=src python3 scripts/engine_bench_torch.py \\
        [--width reduced|full] [--kv-bits 16|8|4] [--out FILE] [--cpu]

``--width reduced`` (default) is the reference bench's shape
(``benchmarks/engine_bench.py``: 8 lanes, 6-token prompts padded to 8,
max_len 64, f32); ``full`` serves the full-width model in bf16 with
8-token prompts (the pad: the Scheduler then admits at the engine's prompt
width, so both run the same matmul shapes, whose bf16 rounding may depend
on the row count). ``--kv-bits 8`` / ``4`` calibrate and pack the integer
deploy path as the launcher does (``--quantize --deploy-int8``), so
decode runs the int8 / int4 dense attention kernel; 16 serves the float
params. The JSON goes to ``--out`` (default
``chiprun_out/engine_bench_torch.json``). The reference bench's sharded
child mode is not ported (mesh placement is not).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

BATCH_SLOTS = 8
MAX_LEN = 64
QUOTA = 8
WARMUP = 3
N_CALLS = 20
# (prompt length, prompt pad) per width
PROMPTS = {"reduced": (6, 8), "full": (8, 8)}


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device):
    """(result, ms) of one call between two device synchronisations."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, (time.perf_counter() - t0) * 1e3


def triad_times(eng, vocab, prompt_len):
    """{op: [ms per call]} for ``prefill``, ``insert`` and ``generate`` on
    an engine whose lanes are all occupied first; generate calls run one
    decode chain (tokens fed back, positions advanced), so each call is
    a real decode step. The caller's engine keeps its scratch cache."""
    from repro_torch.runtime.engine import DecodeState
    rng = np.random.RandomState(1)
    dev = eng.device

    def prompt():
        return rng.randint(1, vocab, size=prompt_len).astype(np.int32)

    state = eng.init_state()
    payloads = []
    for slot in range(eng.batch_slots):
        _, payload = eng.prefill(prompt())
        payloads.append(payload)
        state = eng.insert(payload, slot, state)
    for _ in range(WARMUP):
        toks, cache = eng.generate(state)
        state = DecodeState(toks, state.pos + 1, cache)
    times = {"prefill": [], "insert": [], "generate": []}
    for _ in range(N_CALLS):
        times["prefill"].append(_timed(lambda: eng.prefill(prompt()),
                                       dev)[1])
    for _ in range(N_CALLS):
        state, ms = _timed(lambda: eng.insert(payloads[0], 0, state), dev)
        times["insert"].append(ms)
    for _ in range(N_CALLS):
        (toks, cache), ms = _timed(lambda: eng.generate(state), dev)
        state = DecodeState(toks, state.pos + 1, cache)
        times["generate"].append(ms)
    return times


def _requests(vocab, prompt_len, seed):
    from repro_torch.runtime import Request
    rng = np.random.RandomState(seed)
    return [Request(rid=i, prompt=rng.randint(1, vocab, size=prompt_len)
                    .astype(np.int32), max_new_tokens=QUOTA)
            for i in range(2 * BATCH_SLOTS)]


def build(width, kv_bits, device):
    """(cfg, params, ctx_factory, dtype) of the bench's model: seeded
    params, and with kv_bits 8 / 4 the launcher's calibration and packing
    (W8, or W4 at kv_bits 4)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    cfg = get_config("gemma2-2b")
    if width == "reduced":
        cfg = cfg.reduced()
    dtype = torch.float32 if width == "reduced" else torch.bfloat16
    params = tfm.init_params(cfg, 0, stacked=True, dtype=dtype,
                             device=device)
    if kv_bits == 16:
        return cfg, params, None, dtype
    argv = ["--arch", "gemma2-2b", "--quantize", "--deploy-int8",
            "--kv-bits", str(kv_bits), "--prompt-len",
            str(PROMPTS[width][0]), "--max-len", str(MAX_LEN)]
    if kv_bits == 4:
        argv += ["--weight-bits", "4"]
    args = serve.build_parser().parse_args(argv)
    params, ctx = serve._quantize(cfg, args, params, dtype, device)
    return cfg, params, ctx, dtype


def parity_tokens(cfg, params, ctx, dtype, kv_bits, eng, prompt_len):
    """serve_engine's greedy tokens against the continuous Scheduler's on
    the same 2 x batch_slots requests: asserted equal; returns the count."""
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import serve, serve_engine
    from repro_torch.runtime.steps import make_admit_step, make_decode_step
    eng_reqs = _requests(cfg.vocab_size, prompt_len, 3)
    serve_engine(eng, eng_reqs)
    sched_reqs = _requests(cfg.vocab_size, prompt_len, 3)
    serve(None, make_decode_step(cfg, ctx_factory=ctx),
          lambda b: tfm.init_cache(cfg, b, MAX_LEN, dtype=dtype,
                                   kv_bits=kv_bits, device=eng.device),
          params, sched_reqs, scheduler="continuous",
          batch_slots=BATCH_SLOTS, max_len=MAX_LEN,
          admit_step=make_admit_step(cfg, ctx_factory=ctx),
          device=eng.device)
    for a, b in zip(eng_reqs, sched_reqs):
        assert a.tokens_out == b.tokens_out, \
            f"engine != scheduler greedy tokens (rid {a.rid})"
    return sum(len(r.tokens_out) for r in eng_reqs)


def _card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", choices=("reduced", "full"),
                    default="reduced")
    ap.add_argument("--kv-bits", type=int, choices=(16, 8, 4), default=16)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "engine_bench_torch.json"))
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch versions on the CPU")
    args = ap.parse_args(argv)
    import torch
    from repro_torch.device import resolve_device
    from repro_torch.runtime import make_engine
    device = resolve_device("cpu" if args.cpu else None)
    prompt_len, pad = PROMPTS[args.width]
    cfg, params, ctx, dtype = build(args.width, args.kv_bits, device)
    eng = make_engine(cfg, params, batch_slots=BATCH_SLOTS,
                      prompt_pad_len=pad, max_len=MAX_LEN, dtype=dtype,
                      kv_bits=args.kv_bits, ctx_factory=ctx, device=device)
    tokens = parity_tokens(cfg, params, ctx, dtype, args.kv_bits, eng,
                           prompt_len)
    times = triad_times(eng, cfg.vocab_size, prompt_len)
    counts = eng.signature_counts
    assert set(counts.values()) == {1}, f"step shapes changed: {counts}"
    card = _card() if device.type == "cuda" else None
    rows = []
    for op, ms in times.items():
        rows.append({
            "name": f"engine_{op}", "op": op, "width": args.width,
            "kv_bits": args.kv_bits, "batch_slots": BATCH_SLOTS,
            "prompt_len": prompt_len, "prompt_pad_len": pad,
            "max_len": MAX_LEN, "ms_median": statistics.median(ms),
            "ms_mean": statistics.fmean(ms), "calls_timed": len(ms),
            "parity_tokens_vs_scheduler": tokens})
    gen_ms = rows[-1]["ms_median"]
    rows[-1]["tokens_per_s"] = BATCH_SLOTS / (gen_ms / 1e3)
    doc = {"device": str(device), "card": card,
           "torch": torch.__version__, "step_signatures": counts,
           "rows": rows}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(doc, indent=1) + "\n")
    for r in rows:
        print(f"[engine-bench] {r['name']}: median {r['ms_median']:.3f} ms, "
              f"mean {r['ms_mean']:.3f} ms over {r['calls_timed']} calls "
              f"({args.width}, kv-bits {args.kv_bits}, {device.type})")
    print(f"[engine-bench] {tokens} tokens equal to the continuous "
          f"Scheduler's; step signatures {counts}; card {card}; -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
