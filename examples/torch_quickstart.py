"""Quickstart on the PyTorch port: the paper's pipeline end to end.

1. Build a small BERT with planted structured outliers (the paper's
   Fig.-2 regime).
2. Calibrate activation ranges on a few batches (static range estimation).
3. Quantize W8A8 per-tensor -> see the degradation.
4. Re-quantize with per-embedding-group (PEG) K=4 + range-based
   permutation -> recover.

Run on the GPU:  python3 examples/torch_quickstart.py
Run on the CPU:  python3 examples/torch_quickstart.py cpu
"""
import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import peg_policy, w8a8_policy  # noqa: E402
from repro_torch.core.pipeline import ptq  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import bert  # noqa: E402

OUTLIER_DIMS = (5, 40, 77, 100)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("device", nargs="?", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = bert.tiny()
    params = bert.init_params(cfg, 0, device=dev)
    # plant the paper's structured outliers: a few embedding dims of every
    # FFN output are consistently large
    with torch.no_grad():
        for p in params["layers"]:
            for j, dim in enumerate(OUTLIER_DIMS):
                p["w_out"][:, dim] *= 100.0 - 10 * j

    gen = torch.Generator(device=dev).manual_seed(10)
    calib = [{"tokens": torch.randint(0, cfg.vocab_size, (8, 32),
                                      generator=gen, device=dev)}
             for _ in range(4)]

    def fwd(p, b, ctx):
        return bert.encode(cfg, p, b["tokens"], ctx=ctx)

    with torch.no_grad():
        hidden_fp = fwd(params, calib[0], None)
        print(f"FP32 hidden-state std: {float(torch.std(hidden_fp)):.3f}")

        def rel_err(policy, label):
            qm = ptq(fwd, params, calib, policy)
            hidden_q = fwd(params, calib[0], qm.ctx())
            rel = float(torch.mean(torch.square(hidden_fp - hidden_q)) /
                        torch.mean(torch.square(hidden_fp)))
            print(f"{label:<28s} relative hidden error: {rel:.5f}")
            return qm, rel

        _, e_pt = rel_err(w8a8_policy(), "W8A8 per-tensor PTQ")
        qm, e_peg = rel_err(peg_policy(4), "W8A8 PEG-PTQ (K=4 + perm)")
    print(f"\nPEG recovers {e_pt / max(e_peg, 1e-12):.1f}x of the per-tensor "
          f"quantization error ({dev}).")

    # inspect a PEG spec: the permutation isolates the outlier dims
    site = "layer0/residual_ffn"
    spec = qm.peg_specs[site]
    gi_nat = spec.group_index[spec.inverse_permutation]
    print(f"\n{site}: outlier dims -> groups "
          f"{[int(gi_nat[d]) for d in OUTLIER_DIMS]} "
          f"(all isolated in group {spec.num_groups - 1})")


if __name__ == "__main__":
    main()
