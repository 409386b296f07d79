#!/usr/bin/env python3
"""Compare the full-width decode step of two source trees on one GPU, in
turns (A, B, B, A): device operations per step, device busy time, host
wall time, and whether both trees serve the same greedy tokens.

    python3 scripts/step_ab.py TREE_A TREE_B

TREE_A and TREE_B are repository roots (for example the parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists,
and ``.``). Each turn is its own process: it imports ``repro_torch`` from
that tree, builds its kernels there and serves gemma2-2b at full width
(bf16 params) with the README quickstart's serving flags (``--kv-bits 8``
paged, continuous, chunks of 8, block size 16, max_len 128, 6 requests of
24 tokens, 6 new tokens each) through the tree's launcher. Every decode
step is timed on the host clock around a synchronized call; the third
runs under ``torch.profiler`` (CUDA activity), which counts the device
operations (kernels, copies, fills) it ran and their busy time (the union
of their intervals). Prints per tree the median over its two turns of
the steps' median wall time, of the profiled step's operations and busy
time, each turn's numbers, whether the four turns emitted the same greedy
tokens, and the card's name and power limit. Exits 1 when the tokens
differ.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ARGV = ["--arch", "gemma2-2b", "--quantize", "--deploy-int8", "--kv-bits",
        "8", "--scheduler", "continuous", "--paged-kv", "--prefill-chunk",
        "8", "--requests", "6", "--prompt-len", "24", "--new-tokens", "6",
        "--batch-slots", "4", "--block-size", "16", "--max-len", "128"]
PROFILE_CALL = 3


def busy_ms(spans) -> float:
    """Length of the union of (start, end) intervals, in ms (us in)."""
    spans = sorted(spans)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    return (busy + cur_e - cur_s) / 1e3


def one(tree: Path) -> dict:
    """Serve the workload with this tree's port; the step numbers and a
    digest of the greedy tokens."""
    sys.path.insert(0, str(tree / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import _build
    if Path(_build.__file__).resolve().parents[3] != tree:
        raise RuntimeError(f"imported {_build.__file__}, not from {tree}")
    _build.build_all()
    from repro_torch.launch import serve as launcher
    with profile(activities=[ProfilerActivity.CUDA]):   # CUPTI set-up
        (torch.ones(1, device="cuda") + 1).cpu()
    walls, report, served = [], {}, []
    orig_make, orig_serve = launcher.make_decode_step, launcher.serve

    def make_decode_step(cfg, **kw):
        step = orig_make(cfg, **kw)

        def decode(*args):
            torch.cuda.synchronize()
            if len(walls) + 1 == PROFILE_CALL and "spans" not in report:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    out = step(*args)
                    torch.cuda.synchronize()
                report["spans"] = [
                    (e.time_range.start, e.time_range.end)
                    for e in prof.events() if e.device_type.name == "CUDA"
                    and e.time_range.end > e.time_range.start]
                walls.append(None)
                return out
            t0 = time.perf_counter()
            out = step(*args)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            return out
        return decode

    def serve(*args, **kw):
        served.append(args[4])                # the requests
        return orig_serve(*args, **kw)
    launcher.make_decode_step, launcher.serve = make_decode_step, serve
    with contextlib.redirect_stdout(sys.stderr):
        launcher.main(ARGV)
    steps = [w for w in walls if w is not None]
    return {"step_ms": statistics.median(steps), "steps": len(walls),
            "ops": len(report["spans"]),
            "busy_ms": busy_ms(report["spans"]),
            "tokens": hashlib.sha256(json.dumps(
                [r.tokens_out for r in served[0]]).encode()
            ).hexdigest()[:16]}


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(one(Path(sys.argv[2]).resolve())))
        return 0
    a, b = (Path(p).resolve() for p in sys.argv[1:3])
    runs = {a: [], b: []}
    for tree in (a, b, b, a):
        proc = subprocess.run([sys.executable, __file__, "--one", str(tree)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr[-4000:], file=sys.stderr)
            return 1
        runs[tree].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    for tag, tree in (("A", a), ("B", b)):
        r = runs[tree]
        med = {k: statistics.median(t[k] for t in r)
               for k in ("step_ms", "ops", "busy_ms")}
        turns = "; ".join(f"{t['step_ms']:.2f} ms, {t['ops']} ops, busy "
                          f"{t['busy_ms']:.2f} ms over {t['steps']} steps"
                          for t in r)
        print(f"[step-ab] {tag} {tree}: decode step {med['step_ms']:.2f} ms "
              f"(host, median), profiled step {med['ops']:.0f} device "
              f"operations, device busy {med['busy_ms']:.2f} ms, idle "
              f"{max(0.0, 1 - med['busy_ms'] / med['step_ms']):.1%} "
              f"(turns: {turns})")
    same = len({t["tokens"] for t in runs[a] + runs[b]}) == 1
    print(f"[step-ab] greedy tokens {'equal' if same else 'DIFFER'} in all "
          f"four turns")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
