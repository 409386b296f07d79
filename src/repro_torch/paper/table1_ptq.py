"""Paper Table 1: standard 8-bit post-training quantization (port of
``benchmarks/table1_ptq.py``).

Rows: FP32 / W8A8 / W32A8 / W8A32 on every synthetic-GLUE task + average.
Expected qualitative reproduction: W8A32 ~ FP32 (weights are robust),
W8A8 and W32A8 degrade (activations are the bottleneck).
"""
from __future__ import annotations

from repro_torch.core import FP32, QuantizationPolicy, w8a8_policy
from repro_torch.data.synthetic import GLUE_SUITE
from repro_torch.paper.common import (cached_table, eval_task, glue_average,
                                      quantize_and_eval, table_name,
                                      train_task)

TASKS = GLUE_SUITE


def policies():
    return {
        "W8A8": w8a8_policy(),
        "W32A8": QuantizationPolicy(weight_default=FP32),
        "W8A32": QuantizationPolicy(act_default=FP32),
    }


def compute(tasks=None, device=None):
    rows = {"FP32": {}}
    for name in policies():
        rows[name] = {}
    for task in tasks or TASKS:
        params = train_task(task, device=device)
        rows["FP32"][task.name] = eval_task(task, params, device=device)
        for name, pol in policies().items():
            rows[name][task.name] = quantize_and_eval(task, params, pol,
                                                      device=device)
    for name in rows:
        rows[name]["GLUE"] = glue_average(
            {k: v for k, v in rows[name].items() if k != "GLUE"})
    return rows


def run(tasks=None, device=None):
    return cached_table(table_name("table1_ptq", tasks),
                        lambda: compute(tasks, device))


def report(rows):
    tasks = list(next(iter(rows.values())))
    lines = ["config," + ",".join(tasks)]
    for cfg_name, scores in rows.items():
        lines.append(cfg_name + "," +
                     ",".join(f"{scores[t]:.2f}" for t in tasks))
    return "\n".join(lines)


if __name__ == "__main__":
    print(report(run()))
