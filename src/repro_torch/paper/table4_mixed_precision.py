"""Paper Table 4: mixed-precision PTQ — progressively keep the problematic
tensors in 16-bit (residual FFN sum -> + FFN in/out -> + final output);
port of ``benchmarks/table4_mixed_precision.py``."""
from __future__ import annotations

from repro_torch.core import mixed_precision_policy, w8a8_policy
from repro_torch.data.synthetic import GLUE_SUITE
from repro_torch.paper.common import (cached_table, eval_task,
                                      quantize_and_eval, table_name,
                                      train_task)

TASKS = [t for t in GLUE_SUITE if t.name in
         ("syn-sst2", "syn-mnli", "syn-qnli", "syn-qqp")]

CONFIGS = {
    "W8A8 PTQ": ("w8a8", {}),
    "MP-PTQ (16b residual sum)": ("mp", dict(ffn_io_16bit=False,
                                             output_16bit=False)),
    "MP-PTQ (+16b FFN in/out)": ("mp", dict(ffn_io_16bit=True,
                                            output_16bit=False)),
    "MP-PTQ (+16b final output)": ("mp", dict(ffn_io_16bit=True,
                                              output_16bit=True)),
}


def compute(tasks=None, device=None):
    rows = {"FP32": {}}
    for task in tasks or TASKS:
        params = train_task(task, device=device)
        rows["FP32"][task.name] = eval_task(task, params, device=device)
        for label, (kind, kw) in CONFIGS.items():
            pol = w8a8_policy() if kind == "w8a8" \
                else mixed_precision_policy(**kw)
            rows.setdefault(label, {})[task.name] = \
                quantize_and_eval(task, params, pol, device=device)
    return rows


def run(tasks=None, device=None):
    return cached_table(table_name("table4_mixed_precision", tasks),
                        lambda: compute(tasks, device))


def report(rows):
    tasks = list(next(iter(rows.values())))
    lines = ["config," + ",".join(tasks)]
    for label, scores in rows.items():
        lines.append(f"\"{label}\"," +
                     ",".join(f"{scores[t]:.2f}" for t in tasks))
    return "\n".join(lines)


if __name__ == "__main__":
    print(report(run()))
