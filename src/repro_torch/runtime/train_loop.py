"""Fault-tolerant training loop: checkpoint / restart (with the data
iterator's state), preemption-safe exit, straggler watchdog, step logging
(port of ``repro.runtime.train_loop``). On a rank mesh every rank runs the
loop on its slices (``shardings``): checkpoints hold the logical arrays,
and a SIGTERM or a watchdog trip on any rank reaches every rank (an
``agree_max`` over the mesh's host group after each step) before any of
them enters the collective save."""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.data.pipeline import DataPipeline
from repro_torch.runtime.fault_tolerance import (PreemptionGuard,
                                                 StragglerWatchdog)


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int
    checkpoint_every: int = 100
    log_every: int = 10
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 3
    resume: bool = True


def _block(t: torch.Tensor) -> None:
    """Wait for ``t``'s device (the reference's ``jax.block_until_ready``):
    a step's time then covers its kernels."""
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def run_train_loop(step_fn: Callable, params, opt_state,
                   pipeline: DataPipeline, loop_cfg: TrainLoopConfig, *,
                   put_batch: Optional[Callable] = None, shardings=None,
                   log: Callable[[str], None] = print) -> Dict[str, Any]:
    """Drives ``step_fn(params, opt_state, batch)``.

    Resumes (params, opt, data iterator) from the latest checkpoint when
    present; checkpoints asynchronously every N steps and once more on
    preemption, on a watchdog trip and at the end. ``shardings``: the
    ``(params, opt_state)`` tree of ``parallel.sharding.NamedSharding``
    when they are this rank's slices (every rank of the mesh runs the
    loop): restores cut and saves gather the logical arrays, and the
    preemption and watchdog flags are agreed over the mesh each step. A
    rank that fails mid-step does not save (the save is collective).
    Returns the final state and the logged history."""
    mesh = None
    if shardings is not None:
        from repro_torch.parallel import collectives as coll
        from repro_torch.parallel.sharding import tree_leaves_with_path
        mesh = next(tree_leaves_with_path(shardings))[1].mesh
    ckpt = None
    start_step = 0
    if loop_cfg.checkpoint_dir:
        ckpt = Checkpointer(loop_cfg.checkpoint_dir,
                            keep=loop_cfg.keep_checkpoints)
        if loop_cfg.resume and ckpt.latest_step() is not None:
            (params, opt_state), meta = ckpt.restore((params, opt_state),
                                                     shardings=shardings)
            start_step = int(meta["step"])
            if "data_state" in meta:
                pipeline.restore_state(meta["data_state"])
            log(f"[train] resumed from step {start_step}")

    guard = PreemptionGuard()
    watchdog = StragglerWatchdog()
    history = []

    def save(step):
        if ckpt is not None:
            ckpt.save(step, (params, opt_state),
                      extra={"data_state": pipeline.checkpoint_state()},
                      shardings=shardings)

    step = start_step
    failed = True
    try:
        while step < loop_cfg.total_steps:
            batch = next(pipeline)
            if put_batch is not None:
                batch = put_batch(batch)
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            _block(metrics["loss"])
            dt = time.perf_counter() - t0
            step += 1
            flagged = watchdog.observe(dt)
            if step % loop_cfg.log_every == 0 or flagged:
                loss = float(metrics["loss"])
                msg = (f"[train] step {step} loss {loss:.4f} "
                       f"{dt*1e3:.1f} ms" + ("  STRAGGLER" if flagged else ""))
                log(msg)
                history.append({"step": step, "loss": loss, "time_s": dt})
            if loop_cfg.checkpoint_every and \
                    step % loop_cfg.checkpoint_every == 0:
                save(step)
            preempted, tripped = guard.preempted, watchdog.tripped
            if mesh is not None:
                preempted, tripped = map(bool, coll.agree_max(
                    [int(preempted), int(tripped)], mesh))
            if preempted:
                log(f"[train] preempted at step {step}; checkpointing")
                save(step)
                break
            if tripped:
                log(f"[train] straggler watchdog tripped at step {step}; "
                    "checkpointing for elastic re-mesh")
                save(step)
                watchdog.tripped = False
                watchdog.consecutive = 0
        failed = False
    finally:
        guard.uninstall()
        if ckpt is not None and not (failed and mesh is not None):
            save(step)
            ckpt.wait()

    return {"params": params, "opt_state": opt_state, "step": step,
            "history": history, "straggler_events": watchdog.events}
