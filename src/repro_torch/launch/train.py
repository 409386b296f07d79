"""Training launcher (port of ``repro.launch.train``).

Examples:
  # on the GPU: gemma2-2b at full width (bf16 params, f32 Adam moments)
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
      --steps 5 --batch 2 --seq 1024 --checkpoint-dir build/ckpt

  # the reference's CPU smoke (reduced config, f32):
  PYTHONPATH=src python -c "from repro_torch.launch import train; \\
      train.main('--arch gemma2-2b --reduced --steps 5'.split(), \\
      device='cpu')"

  # on a rank mesh (full width in bf16, as the reference's --mesh path):
  # 4 ranks as (data=2, model=2), FSDP over data, tensor-parallel over model
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
      --mesh 2x2 --steps 3 --batch 4 --seq 1024

The flags are the reference's. ``--mesh DxM`` (or ``DxPxM``, over
(pod, data, model)) spawns one rank a mesh point (``launch.mesh.
run_ranks``; every rank on one card over gloo where the host has fewer
cards than ranks); with ``--reduced`` it takes no mesh, as in the
reference. ``--multi-pod`` (the 256 / 512-chip production mesh) is
refused.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Any, Callable, Tuple

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.data import (DataPipeline, DrawnBatches, LMTaskConfig,
                              SyntheticLM, shard_batch)
from repro_torch.device import resolve_device
from repro_torch.launch.serve import _reject_unported
from repro_torch.models import transformer as tfm
from repro_torch.optim import (adam_init, linear_warmup_linear_decay,
                               qadam_init, tree_leaves)
from repro_torch.runtime import (TrainLoopConfig, make_train_step,
                                 run_train_loop)

_PORTED = {"arch", "shape", "steps", "lr", "reduced", "batch", "seq",
           "microbatches", "checkpoint_dir", "checkpoint_every",
           "no_resume", "seed", "mesh"}


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
    mover and the loop's config; on a rank of a mesh also the (param,
    optimizer state) shardings that ``run_train_loop`` takes."""
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
    shardings: Any = None


def build(args, *, device=None, source=None, optimizer: str = "adam",
          dist=None, cfg=None) -> TrainSetup:
    """The launcher's pieces for parsed ``args`` on ``device`` (None: the
    GPU). ``source`` reuses a data source built for the same vocabulary,
    length and seed (the full-width Markov table takes a minute);
    ``optimizer`` "adam8bit" swaps in 8-bit Adam (the reference's launcher
    trains with Adam only). ``dist``: this rank of ``--mesh``; the whole
    params drawn from the seed (the same numbers on every rank) are placed
    (``parallel.sharding.make_param_shardings``), the optimizer state is
    made on the slices, the step is ``make_train_step(dist=)`` and ``put``
    cuts the rank's rows of each batch (``data.pipeline.shard_batch``).
    ``cfg``: the config as the caller resolved it (a rank takes its job's,
    so that a caller's patched ``get_config`` reaches it)."""
    from repro_torch.parallel.sharding import (logical_params,
                                               make_opt_shardings,
                                               make_param_shardings,
                                               param_shardings)
    dev = resolve_device(device)
    if cfg is None:
        cfg = get_config(args.arch)
        cfg = cfg.reduced() if args.reduced else cfg
    if args.reduced:
        B, T = args.batch or 4, args.seq or 32
        dtype = torch.float32
    else:
        B = args.batch or SHAPES[args.shape]["global_batch"]
        T = args.seq or SHAPES[args.shape]["seq_len"]
        dtype = torch.bfloat16

    params = tfm.init_params(cfg, args.seed, stacked=True, dtype=dtype,
                             device=dev)
    if dist is not None:
        params = make_param_shardings(params, dist)
    if optimizer == "adam8bit":
        opt_state = qadam_init(params, logical=(
            logical_params(cfg) if dist is not None else None))
    else:
        opt_state = adam_init(params)
    shardings = None
    if dist is not None:
        p_sh = param_shardings(cfg, params, dist)
        shardings = (p_sh, make_opt_shardings(opt_state, p_sh, dist))
    lr = linear_warmup_linear_decay(args.lr, args.steps)
    step = make_train_step(cfg, lr_schedule=lr,
                           microbatches=args.microbatches, dist=dist,
                           optimizer=optimizer)
    task = LMTaskConfig(vocab_size=cfg.vocab_size, seq_len=T)
    if source is None:
        source = SyntheticLM(task, seed=args.seed)
    _check_source(source, task, args.seed)
    pipe = DataPipeline(source, batch_size=B, seed=args.seed)

    def put(batch):
        rows = {k: batch[k] for k in ("tokens", "labels")}
        if dist is not None:
            rows = shard_batch(rows, dist, args.microbatches)
        return {k: torch.from_numpy(v).to(dev) for k, v in rows.items()}

    loop_cfg = TrainLoopConfig(
        total_steps=args.steps, checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir, resume=not args.no_resume)
    return TrainSetup(cfg, params, opt_state, step, pipe, put, loop_cfg, B,
                      T, dtype, shardings)


def _check_source(source, task, seed):
    if source.cfg != task or source.seed != seed:
        raise ValueError(f"source {source.cfg} (seed {source.seed}) is not "
                         f"the launcher's {task} (seed {seed})")


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


@dataclasses.dataclass
class MeshJob:
    """What the ranks of ``--mesh`` share (made once, before the spawn):
    the parsed args, the config (resolved here, so a caller's patched
    ``get_config`` reaches the ranks), the mesh's shape and axes, the
    global batch and length and the batches the run takes (drawn once
    from one source: at full width the source takes a minute and 8.4 GB to
    build)."""
    args: argparse.Namespace
    cfg: Any
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    batch: int
    seq: int
    source: DrawnBatches
    log_every: int = 10


def mesh_job(args, *, source=None, log_every: int = 10,
             log: Callable[[str], None] = print) -> MeshJob:
    """The :class:`MeshJob` of parsed ``args`` (``--mesh``, full width in
    bf16). The batches drawn are those from the step a resume starts at
    (the latest checkpoint's data state) to ``--steps``; ``source`` reuses
    a data source built for the same vocabulary, length and seed."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch.mesh import make_mesh_from_spec
    cfg = get_config(args.arch)
    mesh = make_mesh_from_spec(args.mesh)
    B = args.batch or SHAPES[args.shape]["global_batch"]
    T = args.seq or SHAPES[args.shape]["seq_len"]
    dp = math.prod(n for a, n in mesh.shape.items() if a != "model")
    if B % (dp * args.microbatches):
        raise ValueError(f"a batch of {B} rows does not split into "
                         f"{args.microbatches} microbatches over {dp} "
                         "data-parallel ranks")
    task = LMTaskConfig(vocab_size=cfg.vocab_size, seq_len=T)
    if source is None:
        source = SyntheticLM(task, seed=args.seed)
    _check_source(source, task, args.seed)
    start = 0
    if args.checkpoint_dir and not args.no_resume:
        ckpt = Checkpointer(args.checkpoint_dir)
        if ckpt.latest_step() is not None:
            start = int(ckpt.restore({})[1].get("data_state", {}).get(
                "step", 0))
    t0 = time.perf_counter()
    drawn = DrawnBatches(source, B, range(start, args.steps))
    log(f"[train] {len(drawn.batches)} batches of {B} x {T} drawn for the "
        f"ranks in {time.perf_counter() - t0:.1f} s")
    return MeshJob(args, cfg, tuple(mesh.shape.values()), mesh.axis_names,
                   B, T, drawn, log_every)


def mesh_rank(dist, dev, job: MeshJob) -> dict:
    """One rank of ``--mesh``: :func:`build` on the rank's device with its
    ``dist`` and the job's config and batches, then ``run_train_loop``
    with the shardings. Returns the rank's report: the loop's step,
    history and straggler events, its log lines (rank 0), host seconds
    and bytes of its collectives, resident parameter and moment bytes
    against the whole, peak device memory."""
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.sharding import logical_params
    s = build(job.args, device=dev, source=job.source, dist=dist,
              cfg=job.cfg)
    n_whole = sum(t.numel() for t in tree_leaves(logical_params(job.cfg)))
    loop_cfg = dataclasses.replace(s.loop_cfg, log_every=job.log_every)
    lines = []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    coll.seconds = 0.0
    coll.nbytes.clear()
    out = run_train_loop(s.step, s.params, s.opt_state, s.pipe, loop_cfg,
                         put_batch=s.put, shardings=s.shardings,
                         log=lines.append if dist.mesh.rank == 0
                         else (lambda line: None))
    return {"rank": dist.mesh.rank, "coords": dict(dist.mesh.coords),
            "device": str(dev), "step": out["step"],
            "history": out["history"],
            "straggler_events": out["straggler_events"], "lines": lines,
            "collective_s": coll.seconds, "collective_bytes":
            dict(coll.nbytes),
            "param_bytes": _tree_bytes(out["params"]),
            "whole_param_bytes": n_whole * s.dtype.itemsize,
            "moment_bytes": _tree_bytes((out["opt_state"].mu,
                                         out["opt_state"].nu)),
            "whole_moment_bytes": 8 * n_whole,
            "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else 0)}


def main(argv=None, device=None, *, source=None, log_every: int = 10,
         log: Callable[[str], None] = print, report=None):
    """Parse, build and train; returns ``run_train_loop``'s result, or
    with ``--mesh`` rank 0's report (:func:`mesh_rank`; ``report``, a
    list, receives every rank's). ``device`` None means the GPU.
    Keyword-only, not flags: ``source`` (see :func:`build`) and
    ``log_every``, the loop's logging period (the reference's default
    10)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    _reject_unported(ap, args, _PORTED)
    if args.mesh and not args.reduced:
        from repro_torch.launch.mesh import run_ranks
        job = mesh_job(args, source=source, log_every=log_every, log=log)
        ranks = run_ranks(mesh_rank, math.prod(job.shape), (job,),
                          device=device, shape=job.shape, axes=job.axes)
        for line in ranks[0]["lines"]:
            log(line)
        if report is not None:
            report.extend(ranks)
        print(f"[train] finished at step {ranks[0]['step']}; "
              f"{len(ranks[0]['straggler_events'])} straggler events "
              f"({len(ranks)} ranks, mesh {args.mesh})")
        return ranks[0]
    s = build(args, device=device, source=source)
    loop_cfg = dataclasses.replace(s.loop_cfg, log_every=log_every)
    out = run_train_loop(s.step, s.params, s.opt_state, s.pipe, loop_cfg,
                         put_batch=s.put, log=log)
    print(f"[train] finished at step {out['step']}; "
          f"{len(out['straggler_events'])} straggler events")
    return out


if __name__ == "__main__":
    main()
