"""Paper Table 6: comparison of all proposed methods on the full suite —
W8A8 PTQ baseline vs MP-PTQ vs PEG-PTQ (K + permutation) vs per-tensor QAT
(port of ``benchmarks/table6_methods.py``; ``labels`` computes a subset of
the rows)."""
from __future__ import annotations

from repro_torch.core import (mixed_precision_policy, peg_policy,
                              w8a8_policy)
from repro_torch.data.synthetic import GLUE_SUITE
from repro_torch.paper.common import (cached_table, eval_qat, eval_task,
                                      glue_average, qat_finetune,
                                      quantize_and_eval, table_name,
                                      train_task)

TASKS = GLUE_SUITE
LABELS = ("FP32", "W8A8 PTQ", "W8A{8,16} MP-PTQ", "W8A8 PEG-PTQ (K=4+P)",
          "W8A8 QAT")


def compute(tasks=None, labels=None, device=None):
    labels = labels or LABELS
    rows = {label: {} for label in LABELS if label in labels}
    ptq_policies = {"W8A8 PTQ": w8a8_policy,
                    "W8A{8,16} MP-PTQ": mixed_precision_policy,
                    "W8A8 PEG-PTQ (K=4+P)": lambda: peg_policy(4)}
    for task in tasks or TASKS:
        params = train_task(task, device=device)
        if "FP32" in rows:
            rows["FP32"][task.name] = eval_task(task, params, device=device)
        for label, pol in ptq_policies.items():
            if label in rows:
                rows[label][task.name] = quantize_and_eval(
                    task, params, pol(), device=device)
        if "W8A8 QAT" in rows:
            qat_params, ctx_factory = qat_finetune(task, params,
                                                   w8a8_policy(),
                                                   device=device)
            rows["W8A8 QAT"][task.name] = eval_qat(task, qat_params,
                                                   ctx_factory,
                                                   device=device)
    for name in rows:
        rows[name]["GLUE"] = glue_average(
            {k: v for k, v in rows[name].items() if k != "GLUE"})
    return rows


def run(tasks=None, labels=None, device=None):
    return cached_table(table_name("table6_methods", tasks, labels),
                        lambda: compute(tasks, labels, device))


def report(rows):
    tasks = list(next(iter(rows.values())))
    lines = ["method," + ",".join(tasks)]
    for label, scores in rows.items():
        lines.append(f"\"{label}\"," +
                     ",".join(f"{scores[t]:.2f}" for t in tasks))
    return "\n".join(lines)


if __name__ == "__main__":
    print(report(run()))
