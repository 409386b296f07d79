"""The paper's problem investigation (Fig. 2 / App. D) on the PyTorch
port: per-embedding-dimension activation ranges of the FFN input vs
output, the outlier dims (>6 sigma), and their correlation with separator
tokens, on the bench BERT trained for syn-mnli (cached under
``build/paper_results/``).

Run on the GPU:  python3 examples/torch_outlier_analysis.py
Run on the CPU:  python3 examples/torch_outlier_analysis.py cpu
"""
import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.calibration import collect_ranges  # noqa: E402
from repro_torch.core.quant_config import (A8_DEFAULT,  # noqa: E402
                                           QuantizationPolicy)
from repro_torch.data.synthetic import GLUE_SUITE  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import bert  # noqa: E402
from repro_torch.paper.common import (OUTLIER_DIMS, _task_src,  # noqa: E402
                                      bench_cfg, to_device, train_task)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("device", nargs="?", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    task = GLUE_SUITE[5]        # syn-mnli (the paper uses MNLI for Fig. 2)
    print(f"training/loading {task.name} ({dev}) ...")
    params = train_task(task, device=dev)
    cfg = bench_cfg(task)
    src = _task_src(task)
    batches = [to_device(src.batch(16, 500_000 + i), dev) for i in range(4)]

    def fwd(p, b, ctx):
        return bert.encode(cfg, p, b["tokens"], type_ids=b.get("type_ids"),
                           pad_mask=b.get("pad_mask"), ctx=ctx)

    pol = QuantizationPolicy(act_default=A8_DEFAULT)
    states, tensors = collect_ranges(fwd, params, batches, pol)

    L = cfg.num_layers
    print("\nper-layer FFN input vs output dynamic range (paper Fig. 2a):")
    print(f"{'layer':>5} {'in_range':>9} {'out_range':>9} {'ratio':>6} "
          f"{'outlier dims (>6 std)':<30}")
    for i in range(L):
        rin = states[f"layer{i}/ffn_in"]
        rout = states[f"layer{i}/ffn_out"]
        in_rng = float(torch.max(rin.x_max - rin.x_min))
        out_rng = float(torch.max(rout.x_max - rout.x_min))
        x = tensors[f"layer{i}/ffn_out"]
        std = float(torch.std(x, correction=0))
        per_dim_amax = torch.amax(torch.abs(x), dim=(0, 1)).cpu().numpy()
        outliers = np.where(per_dim_amax > 6 * std)[0]
        print(f"{i:>5} {in_rng:>9.2f} {out_rng:>9.2f} "
              f"{out_rng / max(in_rng, 1e-9):>6.1f} "
              f"{outliers.tolist()!s:<30}")

    print(f"\nplanted outlier dims at init: {list(OUTLIER_DIMS)}")
    x = tensors[f"layer{L - 1}/residual_ffn"].cpu().numpy()
    std = float(np.std(x))
    per_dim = np.max(np.abs(x), axis=(0, 1))
    top = np.argsort(per_dim)[-6:][::-1]
    print("top residual_ffn dims by |activation| (should contain the "
          f"planted dims): {top.tolist()}")

    # paper Fig. 2b: outliers consistent ACROSS sequences
    hits = np.abs(x) > 6 * std                    # (B, T, d)
    per_seq_dims = [set(np.where(hits[b].any(0))[0])
                    for b in range(hits.shape[0])]
    common = set.intersection(*per_seq_dims) if per_seq_dims else set()
    print(f"outlier dims shared by ALL {hits.shape[0]} sequences: "
          f"{sorted(int(d) for d in common)}")

    # [SEP]-token correlation (paper §3): range at separator positions
    toks = batches[-1]["tokens"].cpu().numpy()
    sep_pos = toks == 2
    sep_amax = float(np.max(np.abs(x[sep_pos]))) if sep_pos.any() else 0.0
    other_amax = float(np.max(np.abs(x[~sep_pos])))
    print(f"max |residual_ffn| at [SEP] positions: {sep_amax:.2f} vs "
          f"elsewhere: {other_amax:.2f}")


if __name__ == "__main__":
    main()
