"""Training launcher (port of ``repro.launch.train``).

Examples:
  # on the GPU: gemma2-2b at full width (bf16 params, f32 Adam moments)
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
      --steps 5 --batch 2 --seq 1024 --checkpoint-dir build/ckpt

  # the reference's CPU smoke (reduced config, f32):
  PYTHONPATH=src python -c "from repro_torch.launch import train; \\
      train.main('--arch gemma2-2b --reduced --steps 5'.split(), \\
      device='cpu')"

The flags are the reference's; ``--mesh`` and ``--multi-pod`` wait for
multi-device training (ROADMAP Queue 1 item 6) and are refused.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.data import DataPipeline, LMTaskConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.serve import _reject_unported
from repro_torch.models import transformer as tfm
from repro_torch.optim import (adam_init, linear_warmup_linear_decay,
                               qadam_init)
from repro_torch.runtime import (TrainLoopConfig, make_train_step,
                                 run_train_loop)

_PORTED = {"arch", "shape", "steps", "lr", "reduced", "batch", "seq",
           "microbatches", "checkpoint_dir", "checkpoint_every",
           "no_resume", "seed"}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--mesh", default=None, help="e.g. 16x16 or 2x16x16")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU smoke)")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=100)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    return ap


@dataclasses.dataclass
class TrainSetup:
    """What ``main`` builds before it trains: the config, the initial
    params and optimizer state, the step, the data pipeline, the batch
    mover and the loop's config."""
    cfg: Any
    params: Any
    opt_state: Any
    step: Callable
    pipe: DataPipeline
    put: Callable
    loop_cfg: TrainLoopConfig
    batch: int
    seq: int
    dtype: torch.dtype


def build(args, *, device=None, source=None,
          optimizer: str = "adam") -> TrainSetup:
    """The launcher's pieces for parsed ``args`` on ``device`` (None: the
    GPU). ``source`` reuses a data source built for the same vocabulary,
    length and seed (the full-width Markov table takes a minute);
    ``optimizer`` "adam8bit" swaps in 8-bit Adam (the reference's launcher
    trains with Adam only)."""
    dev = resolve_device(device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
        B, T = args.batch or 4, args.seq or 32
        dtype = torch.float32
    else:
        B = args.batch or SHAPES[args.shape]["global_batch"]
        T = args.seq or SHAPES[args.shape]["seq_len"]
        dtype = torch.bfloat16

    params = tfm.init_params(cfg, args.seed, stacked=True, dtype=dtype,
                             device=dev)
    opt_state = (qadam_init if optimizer == "adam8bit" else adam_init)(
        params)
    lr = linear_warmup_linear_decay(args.lr, args.steps)
    step = make_train_step(cfg, lr_schedule=lr,
                           microbatches=args.microbatches,
                           optimizer=optimizer)
    task = LMTaskConfig(vocab_size=cfg.vocab_size, seq_len=T)
    if source is None:
        source = SyntheticLM(task, seed=args.seed)
    elif source.cfg != task or source.seed != args.seed:
        raise ValueError(f"source {source.cfg} (seed {source.seed}) is not "
                         f"the launcher's {task} (seed {args.seed})")
    pipe = DataPipeline(source, batch_size=B, seed=args.seed)

    def put(batch):
        return {k: torch.from_numpy(batch[k]).to(dev)
                for k in ("tokens", "labels")}

    loop_cfg = TrainLoopConfig(
        total_steps=args.steps, checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir, resume=not args.no_resume)
    return TrainSetup(cfg, params, opt_state, step, pipe, put, loop_cfg, B,
                      T, dtype)


def main(argv=None, device=None, *, source=None, log_every: int = 10,
         log: Callable[[str], None] = print):
    """Parse, build and train; returns ``run_train_loop``'s result.
    ``device`` None means the GPU. Keyword-only, not flags: ``source`` (see
    :func:`build`) and ``log_every``, the loop's logging period (the
    reference's default 10)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    _reject_unported(ap, args, _PORTED)
    s = build(args, device=device, source=source)
    loop_cfg = dataclasses.replace(s.loop_cfg, log_every=log_every)
    out = run_train_loop(s.step, s.params, s.opt_state, s.pipe, loop_cfg,
                         put_batch=s.put, log=log)
    print(f"[train] finished at step {out['step']}; "
          f"{len(out['straggler_events'])} straggler events")
    return out


if __name__ == "__main__":
    main()
