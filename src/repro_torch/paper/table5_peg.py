"""Paper Table 5: per-embedding-group activation quantization vs number of
groups K, with/without the range-based permutation (port of
``benchmarks/table5_peg.py``).

The bench BERT has d=64 (vs the paper's 768); K values scale accordingly:
paper {768, 6, 3} -> ours {64 (= per-embedding), 4, 2}."""
from __future__ import annotations

from repro_torch.core import peg_policy, w8a8_policy
from repro_torch.data.synthetic import GLUE_SUITE
from repro_torch.paper.common import (BENCH_CFG, cached_table, eval_task,
                                      quantize_and_eval, table_name,
                                      train_task)

TASKS = [t for t in GLUE_SUITE if t.name in
         ("syn-sst2", "syn-mnli", "syn-qnli", "syn-qqp")]

D = BENCH_CFG["d_model"]

CONFIGS = {
    "K=1 (= per-tensor)": None,                    # plain W8A8
    f"K={D} (= per-embd, FFN only)": dict(num_groups=D,
                                          use_permutation=False),
    "K=4 (FFN only)": dict(num_groups=4, use_permutation=False),
    "K=2 (FFN only)": dict(num_groups=2, use_permutation=False),
    "K=2 + P (FFN only)": dict(num_groups=2, use_permutation=True),
    "K=4 + P (FFN only)": dict(num_groups=4, use_permutation=True),
}


def compute(tasks=None, device=None):
    rows = {"FP32": {}}
    for task in tasks or TASKS:
        params = train_task(task, device=device)
        rows["FP32"][task.name] = eval_task(task, params, device=device)
        for label, kw in CONFIGS.items():
            pol = w8a8_policy() if kw is None else peg_policy(**kw)
            rows.setdefault(label, {})[task.name] = \
                quantize_and_eval(task, params, pol, device=device)
    return rows


def run(tasks=None, device=None):
    return cached_table(table_name("table5_peg", tasks),
                        lambda: compute(tasks, device))


def report(rows):
    tasks = list(next(iter(rows.values())))
    lines = ["num_groups," + ",".join(tasks)]
    for label, scores in rows.items():
        lines.append(f"\"{label}\"," +
                     ",".join(f"{scores[t]:.2f}" for t in tasks))
    return "\n".join(lines)


if __name__ == "__main__":
    print(report(run()))
