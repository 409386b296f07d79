#!/usr/bin/env python3
"""What a cut of one of ``chip_smoke.py``'s phase groups saves, on one
card in one call: the group run once at each setting, in the order given.

    python3 scripts/phase_cut_ab.py serving 4 2        # GEMMA_DEPTH
    python3 scripts/phase_cut_ab.py paper-tables 2 1   # tasks in PAPER_TASKS
    python3 scripts/phase_cut_ab.py rec 8 5            # recurrentgemma-2b's
                                                       # REC_DEPTH
    python3 scripts/phase_cut_ab.py paper-bert 6 6 3   # BERT_DEPTH, after
                                                       # a warm-up run

Several groups may follow one another on one command line (``serving 4 2
rec 8 5``), and a setting may come again (``paper-bert 6 6 3 6 3``): the
first run of the call carries the process's one-off CUDA warm-up (about
20 s for ``paper-bert``), so compare only runs after it. Builds the kernels first, then runs the group's phase
functions with every check of theirs (``serving``: phases 3-18,
``chip_smoke.gemma_serving_phases``; ``paper-tables``: phase 20 on the
first N of syn-stsb and syn-mnli; ``rec``: phases 31-34;
``paper-bert``: phase 19 at N layers), and prints
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
