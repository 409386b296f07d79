"""Paper Table 2: leave-one-out analysis of activation quantizers (port of
``benchmarks/table2_ablation.py``).

All activations quantized at 8-bit except one named group kept FP32.
Expected reproduction: excluding the residual-FFN path recovers by far the
most metric (the paper's headline diagnosis)."""
from __future__ import annotations

from repro_torch.core import FP32, QuantizationPolicy
from repro_torch.data.synthetic import GLUE_SUITE
from repro_torch.paper.common import (cached_table, eval_task,
                                      quantize_and_eval, table_name,
                                      train_task)

# Table-2 row patterns (site regexes)
GROUPS = {
    "none (FP32 acts)": None,
    "all": "",
    "all, except softmax input": r".*/softmax_in",
    "all, except sum of embeddings": r"embed/.*",
    "all, except self-attention output": r".*/ctx_out",
    "all, except softmax output": r".*/softmax_out",
    "all, except residual+FFN path": r".*/(ffn_(in|out)|residual_ffn)",
}

# the paper runs this on its 4 problematic tasks; ours: the 4 best learners
TASKS = [t for t in GLUE_SUITE if t.name in
         ("syn-sst2", "syn-mnli", "syn-qnli", "syn-qqp")]


def compute(tasks=None, device=None):
    rows = {}
    for label, pattern in GROUPS.items():
        rows[label] = {}
        for task in tasks or TASKS:
            params = train_task(task, device=device)
            if label == "none (FP32 acts)":
                rows[label][task.name] = eval_task(task, params,
                                                   device=device)
                continue
            overrides = {pattern: FP32} if pattern else {}
            pol = QuantizationPolicy(weight_default=FP32,
                                     act_overrides=overrides)
            rows[label][task.name] = quantize_and_eval(task, params, pol,
                                                       device=device)
    return rows


def run(tasks=None, device=None):
    return cached_table(table_name("table2_ablation", tasks),
                        lambda: compute(tasks, device))


def report(rows):
    tasks = list(next(iter(rows.values())))
    lines = ["excluded_group," + ",".join(tasks)]
    for label, scores in rows.items():
        lines.append(f"\"{label}\"," +
                     ",".join(f"{scores[t]:.2f}" for t in tasks))
    return "\n".join(lines)


if __name__ == "__main__":
    print(report(run()))
