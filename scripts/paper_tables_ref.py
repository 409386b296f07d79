#!/usr/bin/env python3
"""The reference's paper-table rows (JAX, on the CPU) for the set of rows
that ``chip_smoke.py``'s ``[paper-tables]`` phase computes on the port:
Table 1 and Table 5 over all eight synthetic tasks, Table 6's W8A8 PTQ and
QAT rows and Table 7's W4A32 PTQ and AdaRound rows on syn-mnli, each with
the reference's own ``benchmarks/common.py`` harness.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/paper_tables_ref.py \\
        [--seed 0] [--out build/paper_results_ref]

Checkpoints go under ``--out`` (the reference's own cache directory is not
touched) and the rows are printed as ``table,row,task,score`` lines and
written to ``<out>/rows.json``. This is the reference side of the
comparison; the port's rows come from ``chip_smoke.py`` or
``scripts/paper_tables_torch.py``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "src"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(REPO / "build" /
                                         "paper_results_ref"))
    args = ap.parse_args(argv)
    from benchmarks import common
    from benchmarks import table1_ptq, table5_peg
    from repro.core import (low_bit_weight_policy, peg_policy, w8a8_policy)
    from repro.data.synthetic import GLUE_SUITE
    out = Path(args.out)
    common.RESULTS_DIR = str(out)
    common.CKPT_DIR = str(out / "bert_ckpts")
    rows, t0 = {}, time.time()

    def put(table, row, task, score):
        rows.setdefault(table, {}).setdefault(row, {})[task] = score
        print(f"{table},{row},{task},{score:.2f}", flush=True)

    for task in GLUE_SUITE:
        params = common.train_task(task, seed=args.seed)
        fp32 = common.eval_task(task, params)
        put("t1", "FP32", task.name, fp32)
        put("t5", "FP32", task.name, fp32)
        for name, pol in table1_ptq.policies().items():
            put("t1", name, task.name,
                common.quantize_and_eval(task, params, pol))
        for label, kw in table5_peg.CONFIGS.items():
            pol = w8a8_policy() if kw is None else peg_policy(**kw)
            put("t5", label, task.name,
                common.quantize_and_eval(task, params, pol))
    mnli = GLUE_SUITE[5]
    params = common.train_task(mnli, seed=args.seed)
    put("t6", "W8A8 PTQ", mnli.name,
        common.quantize_and_eval(mnli, params, w8a8_policy()))
    qp, ctxf = common.qat_finetune(mnli, params, w8a8_policy())
    put("t6", "W8A8 QAT", mnli.name, common.eval_qat(mnli, qp, ctxf))
    put("t7", "W4A32 PTQ", mnli.name,
        common.quantize_and_eval(mnli, params, low_bit_weight_policy(4)))
    put("t7", "W4A32 AdaRound", mnli.name, common.quantize_and_eval(
        mnli, params, low_bit_weight_policy(4), adaround_ffn=True))
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "rows.json", "w") as f:
        json.dump(rows, f, indent=1)
    print(f"# {time.time() - t0:.1f} s (JAX on the CPU)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
