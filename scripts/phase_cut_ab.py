#!/usr/bin/env python3
"""What a cut of one of ``chip_smoke.py``'s phase groups saves, on one
card in one call: the group run once at each setting, in the order given.

    python3 scripts/phase_cut_ab.py serving 4 2        # GEMMA_DEPTH
    python3 scripts/phase_cut_ab.py paper-tables 2 1   # tasks in PAPER_TASKS
    python3 scripts/phase_cut_ab.py rec 8 5            # recurrentgemma-2b's
                                                       # REC_DEPTH
    python3 scripts/phase_cut_ab.py paper-bert 6 6 3   # BERT_DEPTH, after
                                                       # a warm-up run
    python3 scripts/phase_cut_ab.py zoo 4 4 2          # qwen3-moe-235b's
                                                       # ZOO_DEPTH
    python3 scripts/phase_cut_ab.py rwkv 4 2           # rwkv6-1p6b's
                                                       # REC_DEPTH
    python3 scripts/phase_cut_ab.py oc-tokens 32 16    # FULL_OC's new
                                                       # tokens
    python3 scripts/phase_cut_ab.py zoo-tp 0 0 1       # every ZOO_DEPTH
                                                       # and TP_MOE_DEPTH
                                                       # (0: as they are)
    python3 scripts/phase_cut_ab.py train-rec 0 5      # phases 41-42's
                                                       # depth (0: all)

Several groups may follow one another on one command line (``serving 4 2
rec 8 5``), and a setting may come again (``paper-bert 6 6 3 6 3``): the
first run of the call carries the process's one-off CUDA warm-up (about
20 s for ``paper-bert``), so compare only runs after it. Builds the kernels first, then runs the group's phase
functions with every check of theirs (``serving``: phases 3-18,
``chip_smoke.gemma_serving_phases``; ``paper-tables``: phase 20 on the
first N of syn-stsb and syn-mnli; ``rec``: phases 31-34;
``paper-bert``: phase 19 at N layers; ``zoo``: phases 26-30 with
qwen3-moe-235b at N layers; ``rwkv``: phases 31-34 with rwkv6-1p6b at N
layers; ``oc-tokens``: phases 13-16 with N new tokens a request of the full-width
over-commit workload, at ``GEMMA_DEPTH``; ``zoo-tp``: phases 26-30 and
48-49 with every zoo config and phase 49's qwen3-moe at N layers, 0 for
the depths as they are; ``train-rec``: phases 41-42 training both recurrent archs at N
layers, 0 for all of them), and prints
each run's wall time (host clock) and the card's name and power limit.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO))


def _run(group, setting, add, mark):
    import chip_smoke
    if group == "serving":
        chip_smoke.GEMMA_DEPTH = setting
        chip_smoke.gemma_serving_phases(add, mark)
    elif group == "paper-tables":
        tasks = chip_smoke.PAPER_TASKS
        chip_smoke.PAPER_TASKS = ("syn-stsb", "syn-mnli")[-setting:]
        try:
            chip_smoke.paper_tables_phase(add)
        finally:
            chip_smoke.PAPER_TASKS = tasks
    elif group == "rec":
        depth = dict(chip_smoke.REC_DEPTH)
        chip_smoke.REC_DEPTH["recurrentgemma-2b"] = setting
        try:
            chip_smoke.rec_phase(add)
        finally:
            chip_smoke.REC_DEPTH.update(depth)
    elif group == "paper-bert":
        chip_smoke.paper_bert_phase(add, num_layers=setting)
    elif group == "rwkv":
        depth = dict(chip_smoke.REC_DEPTH)
        chip_smoke.REC_DEPTH["rwkv6-1p6b"] = setting
        try:
            chip_smoke.rec_phase(add)
        finally:
            chip_smoke.REC_DEPTH.update(depth)
    elif group == "oc-tokens":
        oc = chip_smoke.FULL_OC
        i = oc.index("--new-tokens") + 1
        saved, oc[i] = oc[i], str(setting)
        undo = chip_smoke.cut_depth("gemma2-2b", chip_smoke.GEMMA_DEPTH)
        try:
            chip_smoke.overcommit_phase(add)
            chip_smoke.telemetry_phase(add)
        finally:
            undo()
            oc[i] = saved
    elif group == "zoo-tp":
        zoo, moe = dict(chip_smoke.ZOO_DEPTH), dict(chip_smoke.TP_MOE_DEPTH)
        if setting:
            chip_smoke.ZOO_DEPTH.update({a: setting for a in zoo})
            chip_smoke.TP_MOE_DEPTH.update({a: setting for a in moe})
        try:
            granite = {}
            chip_smoke.zoo_phase(add, served=granite)
            chip_smoke.tp2_launcher_phases(
                add, {kv: runs[0] for kv, runs in granite.items()})
        finally:
            chip_smoke.ZOO_DEPTH.update(zoo)
            chip_smoke.TP_MOE_DEPTH.update(moe)
    elif group == "train-rec":
        depth = dict(chip_smoke.TRAIN_REC_DEPTH)
        chip_smoke.TRAIN_REC_DEPTH.update(
            {a: setting or None for a in depth})
        try:
            src = chip_smoke.train_rec_phase(add, "recurrentgemma-2b")
            del src
            chip_smoke.train_rec_phase(add, "rwkv6-1p6b")
        finally:
            chip_smoke.TRAIN_REC_DEPTH.update(depth)
    elif group == "zoo":
        depth = dict(chip_smoke.ZOO_DEPTH)
        chip_smoke.ZOO_DEPTH["qwen3-moe-235b"] = setting
        try:
            chip_smoke.zoo_phase(add)
        finally:
            chip_smoke.ZOO_DEPTH.update(depth)
    else:
        raise SystemExit(f"unknown group {group!r}")


def main(argv=None):
    import torch
    from repro_torch.kernels import _build
    argv = sys.argv[1:] if argv is None else argv
    runs, group = [], None
    for a in argv:
        if a.isdigit():
            runs.append((group, int(a)))
        else:
            group = a
    if not runs:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        print("phase_cut_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(f"[device] {smi.stdout.strip()}")
    print(f"[build] {_build.build_all():.1f} s")

    def add(counts):
        torch.cuda.empty_cache()

    for group, setting in runs:
        t0 = time.perf_counter()
        _run(group, setting, add, lambda what: print(
            f"[time] {what} done at {time.perf_counter() - t0:.1f} s"))
        print(f"[ab] {group} at {setting}: {time.perf_counter() - t0:.1f} s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
