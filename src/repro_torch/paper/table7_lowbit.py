"""Paper Table 7 / App. C: low-bit weight & token-embedding quantization
(port of ``benchmarks/table7_lowbit.py``; ``labels`` computes a subset of
the rows).

Rows: W6A32 / W4A32 PTQ, W4A32 AdaRound, W4A8 QAT, W4A8 + 2-bit embeddings
QAT — with the paper's memory-reduction accounting."""
from __future__ import annotations

from repro_torch.core import low_bit_weight_policy
from repro_torch.data.synthetic import GLUE_SUITE
from repro_torch.paper.common import (cached_table, eval_qat, eval_task,
                                      glue_average, qat_finetune,
                                      quantize_and_eval, table_name,
                                      train_task)

# run the QAT rows on a subset to bound the time; PTQ rows on all tasks
QAT_TASKS = [t for t in GLUE_SUITE if t.name in
             ("syn-sst2", "syn-mnli", "syn-qnli", "syn-qqp")]


def memory_reduction(weight_bits, embed_bits=None, act_bits=32):
    """Paper's accounting: FP32 checkpoint vs quantized weights+embeddings."""
    e = embed_bits if embed_bits is not None else weight_bits
    # weights ~ embedding fraction of BERT-base: 23.8M of 109M params
    emb_frac = 23.8 / 109.0
    bits = emb_frac * e + (1 - emb_frac) * weight_bits
    return 32.0 / bits


def configs():
    return {
        "FP32": (None, 1.0),
        "W6A32 PTQ": (low_bit_weight_policy(6), memory_reduction(6)),
        "W4A32 PTQ": (low_bit_weight_policy(4), memory_reduction(4)),
        "W4A32 AdaRound": (low_bit_weight_policy(4), memory_reduction(4)),
        "W4A8 QAT": (low_bit_weight_policy(4, act_bits=8),
                     memory_reduction(4)),
        "W4A8 2b-embd QAT": (low_bit_weight_policy(4, act_bits=8,
                                                   embedding_bits=2),
                             memory_reduction(4, embed_bits=2)),
    }


def compute(tasks=None, labels=None, device=None):
    """``tasks`` replaces both task lists (PTQ rows: every task; QAT rows:
    QAT_TASKS)."""
    rows = {}
    for label, (pol, mem) in configs().items():
        if labels and label not in labels:
            continue
        rows[label] = {"memory_reduction": round(mem, 2)}
        default = QAT_TASKS if "QAT" in label else GLUE_SUITE
        for task in tasks or default:
            params = train_task(task, device=device)
            if pol is None:
                rows[label][task.name] = eval_task(task, params,
                                                   device=device)
            elif "QAT" in label:
                qp, ctxf = qat_finetune(task, params, pol, device=device)
                rows[label][task.name] = eval_qat(task, qp, ctxf,
                                                  device=device)
            else:
                rows[label][task.name] = quantize_and_eval(
                    task, params, pol, adaround_ffn="AdaRound" in label,
                    device=device)
        rows[label]["avg"] = glue_average(
            {k: v for k, v in rows[label].items()
             if k not in ("memory_reduction", "avg")})
    return rows


def run(tasks=None, labels=None, device=None):
    return cached_table(table_name("table7_lowbit", tasks, labels),
                        lambda: compute(tasks, labels, device))


def report(rows):
    lines = ["method,memory_reduction,avg_metric,per_task"]
    for label, scores in rows.items():
        per_task = ";".join(f"{k}={v:.1f}" for k, v in scores.items()
                            if k not in ("memory_reduction", "avg"))
        lines.append(f"\"{label}\",x{scores['memory_reduction']},"
                     f"{scores['avg']:.2f},\"{per_task}\"")
    return "\n".join(lines)


if __name__ == "__main__":
    print(report(run()))
