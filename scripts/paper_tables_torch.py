#!/usr/bin/env python3
"""The paper's result tables on the PyTorch port (Tables 1, 2, 4, 5, 6, 7
of the paper, on synthetic GLUE; the port of ``benchmarks/run.py``'s table
sections).

    python3 scripts/paper_tables_torch.py [--sections t1,t5] \\
        [--tasks syn-mnli,syn-sst2] [--device cpu] [--fresh]

Runs on the GPU unless ``--device`` says otherwise. Trained checkpoints and
table JSON are cached under ``build/paper_results/``; ``--fresh`` deletes
that directory first. ``--tasks`` replaces every table's task list. Unlike
``benchmarks/run.py`` a failing section is not caught: it fails the run.
"""
from __future__ import annotations

import argparse
import shutil
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

SECTIONS = ["t1", "t2", "t4", "t5", "t6", "t7"]
TITLES = {
    "t1": "Table 1 — standard 8-bit PTQ (paper Table 1)",
    "t2": "Table 2 — leave-one-out activation ablation",
    "t4": "Table 4 — mixed-precision PTQ",
    "t5": "Table 5 — per-embedding-group PTQ (K sweep, ±P)",
    "t6": "Table 6 — method comparison incl. QAT",
    "t7": "Table 7 — low-bit weights & embeddings",
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sections", default=",".join(SECTIONS))
    ap.add_argument("--tasks", default=None,
                    help="comma-separated task names (default: each "
                         "table's own list)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--fresh", action="store_true",
                    help="delete the cached checkpoints and tables first")
    args = ap.parse_args(argv)
    want = args.sections.split(",")
    unknown = sorted(set(want) - set(SECTIONS))
    if unknown:
        ap.error(f"unknown sections {unknown}; choose from {SECTIONS}")

    from repro_torch.data.synthetic import GLUE_SUITE
    from repro_torch.device import resolve_device
    from repro_torch.paper import (common, table1_ptq, table2_ablation,
                                   table4_mixed_precision, table5_peg,
                                   table6_methods, table7_lowbit)
    dev = resolve_device(args.device)
    tasks = None
    if args.tasks:
        by_name = {t.name: t for t in GLUE_SUITE}
        names = args.tasks.split(",")
        missing = [n for n in names if n not in by_name]
        if missing:
            ap.error(f"unknown tasks {missing}; choose from {list(by_name)}")
        tasks = [by_name[n] for n in names]
    if args.fresh:
        shutil.rmtree(common.RESULTS_DIR, ignore_errors=True)

    modules = {"t1": table1_ptq, "t2": table2_ablation,
               "t4": table4_mixed_precision, "t5": table5_peg,
               "t6": table6_methods, "t7": table7_lowbit}
    for name in SECTIONS:
        if name not in want:
            continue
        t0 = time.time()
        print(f"\n### {TITLES[name]}", flush=True)
        mod = modules[name]
        print(mod.report(mod.run(tasks=tasks, device=dev)))
        print(f"# section {name} took {time.time() - t0:.1f}s ({dev})",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
