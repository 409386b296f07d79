"""End-to-end serving on the PyTorch port (the counterpart of
``examples/serve_quantized.py``): serve a small decoder LM with batched
requests through prefill + KV-cache decode, FP32 vs W8A8-PEG-quantized
(simulated) vs the int8 deployment path (the port's CUDA kernels on the
GPU), and compare outputs + timings.

Run on the GPU:  python3 examples/torch_serve_quantized.py
Run on the CPU:  python3 examples/torch_serve_quantized.py cpu
                 (add --arch gemma2-2b etc. to switch the reduced family)
"""
import argparse
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (Mode, QuantCtx, build_deploy,  # noqa: E402
                              peg_policy)
from repro_torch.core.pipeline import ptq  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.runtime import Request, serve_batch  # noqa: E402
from repro_torch.runtime.steps import (make_decode_step,  # noqa: E402
                                       make_prefill_step)


def calibration_tokens(cfg, prompt_len):
    """The PTQ calibration prompts: two batches of 2 x ``prompt_len``
    tokens from numpy seeds 10 and 11."""
    return [np.random.RandomState(10 + i).randint(0, cfg.vocab_size,
                                                  (2, prompt_len))
            for i in range(2)]


def agreement(a, b):
    """Mean per-request share of equal greedy tokens."""
    return np.mean([np.mean(np.asarray(x) == np.asarray(y))
                    for x, y in zip(a, b)])


def main(argv=None, device=None):
    """Serve the three ways and print the reference's lines. Returns a
    namespace: ``tokens`` {label: greedy tokens per request}, ``prompts``,
    and what served them (``cfg``, ``params``, ``packed_params``,
    ``quant_ctx``, ``deploy_ctx``). ``device`` (or the positional
    argument) None means the GPU."""
    ap = argparse.ArgumentParser()
    ap.add_argument("device", nargs="?", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--arch", default="h2o-danube3-4b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--new-tokens", type=int, default=8)
    args = ap.parse_args(argv)
    dev = resolve_device(device if device is not None else args.device)

    cfg = get_config(args.arch).reduced()
    params = tfm.init_params(cfg, 0, dtype=torch.float32, device=dev)

    # --- W8A8 + PEG PTQ, calibrated on synthetic prompts -------------------
    pol = peg_policy(4)
    flat_params = tfm.init_params(cfg, 0, stacked=False,
                                  dtype=torch.float32, device=dev)
    calib = [{"tokens": torch.as_tensor(t, device=dev)}
             for t in calibration_tokens(cfg, args.prompt_len)]

    def fwd(p, b, ctx):
        logits, _ = tfm.forward(cfg, p, b["tokens"], ctx=ctx)
        return logits

    qm = ptq(fwd, flat_params, calib, pol, collect_inputs=True)
    del flat_params
    shared = {}
    for site, qp in qm.act_state.items():
        base = ("layer/" + site.split("/", 1)[1]
                if site.startswith("layer") else site)
        shared.setdefault(base, qp)

    # one memo of fake-quantized weights shared by every ctx of this run
    weight_cache = {}

    def quant_ctx():
        return QuantCtx(policy=pol, mode=Mode.APPLY, act_state=dict(shared),
                        weight_cache=weight_cache)

    # --- integer deployment: packed int8 weights + the port's kernels ------
    packed_params, deploy_acts = build_deploy(cfg, params, pol, dict(shared))

    def deploy_ctx():
        return QuantCtx(policy=pol, mode=Mode.DEPLOY, act_state=dict(shared),
                        deploy_acts=deploy_acts, weight_cache=weight_cache)

    def make_requests():
        # a fresh rng per run, so every label serves the same prompts
        rng = np.random.RandomState(0)
        return [Request(rid=i, prompt=rng.randint(10, cfg.vocab_size,
                                                  size=args.prompt_len),
                        max_new_tokens=args.new_tokens)
                for i in range(args.requests)]

    def run(label, ctx_factory, serve_params=None):
        serve_params = params if serve_params is None else serve_params
        prefill = make_prefill_step(cfg, ctx_factory=ctx_factory)
        decode = make_decode_step(cfg, ctx_factory=ctx_factory)
        reqs = make_requests()
        stats = serve_batch(
            lambda t, pm, c: prefill(serve_params, t, c, pm),
            lambda t, p, c: decode(serve_params, t, p, c),
            lambda b: tfm.init_cache(cfg, b, 64, dtype=torch.float32,
                                     device=dev),
            reqs, batch_slots=4, device=dev)
        tok_s = stats.tokens_generated / max(stats.wall_s, 1e-9)
        print(f"{label:<18s} {stats.tokens_generated} tokens in "
              f"{stats.wall_s:.2f}s ({tok_s:.1f} tok/s)")
        return [r.tokens_out for r in reqs]

    tokens = {"FP32": run("FP32", None),
              "W8A8 PEG (K=4+P)": run("W8A8 PEG (K=4+P)", quant_ctx),
              "int8 deploy": run("int8 deploy", deploy_ctx, packed_params)}
    out_fp, out_q, out_d = tokens.values()
    print(f"\ngreedy-token agreement FP32 vs quantized: "
          f"{agreement(out_fp, out_q) * 100:.1f}% "
          "(an untrained model's logits are near-uniform, so small "
          "quantization noise can flip argmax — trained models agree far "
          "more; see benchmarks tables for task-metric impact)")
    print(f"greedy-token agreement simulated vs int8 deploy: "
          f"{agreement(out_q, out_d) * 100:.1f}% (same quantization math — "
          "differences are f32-associativity ties only)")
    return SimpleNamespace(tokens=tokens,
                           prompts=[r.prompt for r in make_requests()],
                           cfg=cfg, params=params,
                           packed_params=packed_params, quant_ctx=quant_ctx,
                           deploy_ctx=deploy_ctx)


if __name__ == "__main__":
    main()
