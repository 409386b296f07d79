"""End-to-end training on the PyTorch port (port of
``examples/train_e2e.py``): pretrain a decoder LM on the synthetic Markov
LM task with checkpoint / resume, then run a short QAT fine-tune
(quantization in the training graph) from PTQ-initialized ranges.

The default preset is a ~1M-parameter reduced model; ``--preset 100m``
is the 100M-parameter configuration built from h2o-danube3-4b.

Run on the GPU:  python3 examples/torch_train_e2e.py --steps 60
Run on the CPU:  python3 examples/torch_train_e2e.py --steps 60 --device cpu
"""
import argparse
import dataclasses
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import Mode, QuantCtx, w8a8_policy  # noqa: E402
from repro_torch.core.pipeline import ptq  # noqa: E402
from repro_torch.core.qat import init_qat_params  # noqa: E402
from repro_torch.data import (DataPipeline, LMTaskConfig,  # noqa: E402
                              SyntheticLM)
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim import (adam_init, adam_update,  # noqa: E402
                               apply_updates, linear_warmup_linear_decay,
                               value_and_grad)
from repro_torch.runtime import (TrainLoopConfig,  # noqa: E402
                                 make_train_step, run_train_loop)


def preset_cfg(preset: str):
    base = get_config("h2o-danube3-4b")
    if preset == "100m":
        return dataclasses.replace(
            base, name="danube-100m", num_layers=12, d_model=768,
            num_heads=12, num_kv_heads=4, head_dim=64, d_ff=2048,
            vocab_size=32000, window=1024)
    return dataclasses.replace(
        base.reduced(), name="danube-1m", vocab_size=512)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="1m", choices=["1m", "100m"])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--qat-steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--checkpoint-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_e2e"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    return ap


def put_batch(dev):
    return lambda b: {k: torch.from_numpy(b[k]).to(dev)
                      for k in ("tokens", "labels")}


def pretrain(cfg, args, dev, *, log_every: int = 10, wrap_step=None,
             log=print):
    """Adam pretraining with checkpoints every 20 steps under
    ``args.checkpoint_dir`` (resumed when one is there). ``wrap_step``
    wraps the step function (a hook for callers that watch it). Returns
    (``run_train_loop``'s result, the data pipeline)."""
    params = tfm.init_params(cfg, 0, dtype=torch.float32, device=dev)
    opt = adam_init(params)
    lr = linear_warmup_linear_decay(3e-3, args.steps)
    src = SyntheticLM(LMTaskConfig(vocab_size=cfg.vocab_size,
                                   seq_len=args.seq), seed=0)
    pipe = DataPipeline(src, batch_size=args.batch, seed=0)
    step = make_train_step(cfg, lr_schedule=lr)
    if wrap_step is not None:
        step = wrap_step(step)
    out = run_train_loop(
        step, params, opt, pipe,
        TrainLoopConfig(total_steps=args.steps, checkpoint_every=20,
                        log_every=log_every,
                        checkpoint_dir=args.checkpoint_dir),
        put_batch=put_batch(dev), log=log)
    return out, pipe


def shared_act_state(cfg, pipe, dev):
    """W8A8 PTQ on two calibration batches through the unrolled layout of
    a fresh init (as the reference does), each ``layer<i>/...`` site
    folded onto the shared ``layer/...`` name by its first layer."""
    pol = w8a8_policy()
    flat = tfm.init_params(cfg, 0, stacked=False, dtype=torch.float32,
                           device=dev)
    calib = [{"tokens": torch.from_numpy(
        pipe.source.batch(4, 900_000 + i)["tokens"]).to(dev)}
        for i in range(2)]

    def fwd(p, b, ctx):
        logits, _ = tfm.forward(cfg, p, b["tokens"], ctx=ctx)
        return logits

    qm = ptq(fwd, flat, calib, pol)
    shared = {}
    for site, qp in qm.act_state.items():
        base = ("layer/" + site.split("/", 1)[1]
                if site.startswith("layer") else site)
        shared.setdefault(base, qp)
    return pol, shared


def make_qat_step(cfg, pol, shared, qlr):
    """qstep(trainable, qopt, batch) -> (trainable, qopt, loss): weights
    and learnable ranges under one Adam, fake-quant in the graph."""
    def ctx_factory(qat_params=None):
        return QuantCtx(policy=pol, mode=Mode.QAT, act_state=dict(shared),
                        weight_state={}, qat_params=qat_params)

    def loss(tr, batch):
        ctx = ctx_factory(tr["quant"])
        return tfm.train_loss(cfg, tr["model"], batch, ctx=ctx, remat=False)

    def qstep(tr, qopt, batch):
        l, g = value_and_grad(lambda t: loss(t, batch), tr)
        upd, qopt = adam_update(g, qopt, tr, lr=qlr)
        return apply_updates(tr, upd), qopt, l
    return qstep


def qat_finetune(cfg, params, pipe, args, dev, log=print):
    """The QAT phase; returns (trainable, losses, ms a step)."""
    pol, shared = shared_act_state(cfg, pipe, dev)
    trainable = {"model": params, "quant": init_qat_params(shared, {})}
    qopt = adam_init(trainable)
    qstep = make_qat_step(cfg, pol, shared,
                          linear_warmup_linear_decay(5e-4, args.qat_steps))
    put = put_batch(dev)
    losses, walls = [], []
    for i in range(args.qat_steps):
        batch = put(next(pipe))
        t0 = time.perf_counter()
        trainable, qopt, l = qstep(trainable, qopt, batch)
        losses.append(float(l))         # reads the loss back: synchronizes
        walls.append((time.perf_counter() - t0) * 1e3)
        if i % 5 == 0:
            log(f"  qat step {i}: loss {losses[-1]:.4f}")
    return trainable, losses, walls


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = preset_cfg(args.preset)
    out, pipe = pretrain(cfg, args, dev)
    hist = out["history"]
    loss = f"{hist[-1]['loss']:.3f}" if hist else "not logged"
    print(f"pretraining done at step {out['step']} (loss {loss})")

    print("\nQAT fine-tune (W8A8 in the training graph):")
    _, losses, walls = qat_finetune(cfg, out["params"], pipe, args, dev)
    if walls:
        print(f"  {len(walls)} qat steps, {sorted(walls)[len(walls) // 2]:.1f}"
              f" ms a step (median)")
    print("done — quantization-aware training converged alongside the "
          "learnable ranges (paper §4).")


if __name__ == "__main__":
    main()
