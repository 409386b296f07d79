"""Shared harness of the paper-table runs (port of ``benchmarks/common.py``).

Trains a reduced BERT per synthetic-GLUE task with OUTLIER-SCALED
INITIALIZATION: a few designated FFN-output columns start ~40x larger, so
training builds functional structured outliers in the residual stream —
the regime the paper diagnoses in pre-trained BERT (Fig. 2): per-tensor
activation quantization then damages the task metric, and PEG / MP / QAT
recover it.

Every entry point takes ``device`` (None: the GPU). Checkpoints and table
JSON are cached under ``build/paper_results/`` (``RESULTS_DIR``; delete it,
or pass ``--fresh`` to ``scripts/paper_tables_torch.py``, to recompute).
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import (Mode, QuantCtx, QuantizationPolicy,
                              w8a8_policy)
from repro_torch.core.adaround import AdaRoundConfig
from repro_torch.core.calibration import collect_ranges
from repro_torch.core.pipeline import ptq
from repro_torch.core.qat import init_qat_params
from repro_torch.data.synthetic import GLUETaskConfig, SyntheticGLUE
from repro_torch.device import resolve_device
from repro_torch.models import bert
from repro_torch.optim import (adam_init, adam_update, apply_updates,
                               clip_by_global_norm,
                               linear_warmup_linear_decay, tree_leaves,
                               tree_map, tree_unflatten)

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "paper_results"

# Benchmark-scale BERT (the reference's CPU budget).
BENCH_CFG = dict(num_layers=3, d_model=64, num_heads=4, d_ff=256,
                 vocab_size=1024, max_positions=64)
OUTLIER_DIMS = (5, 21, 40, 59)          # spread over all 4 natural chunks
OUTLIER_SCALE = 40.0
TRAIN_STEPS = 250
BATCH = 32
SEQ = 32
TRAIN_LR = 3e-3
EVAL_EXAMPLES = 256


def bench_cfg(task: GLUETaskConfig) -> bert.BertConfig:
    return bert.BertConfig(num_labels=task.num_labels,
                           regression=task.regression, **BENCH_CFG)


def _task_src(task: GLUETaskConfig) -> SyntheticGLUE:
    return SyntheticGLUE(dataclasses.replace(
        task, seq_len=SEQ, vocab_size=BENCH_CFG["vocab_size"]), seed=0)


def to_device(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def init_with_outliers(cfg: bert.BertConfig, seed: int = 0, device=None):
    """``bert.init_params`` with the outlier columns of every ``w_out``
    scaled (in place, before any autograd use)."""
    params = bert.init_params(cfg, seed, device=device)
    with torch.no_grad():
        for p in params["layers"]:
            for j, dim in enumerate(OUTLIER_DIMS):
                p["w_out"][:, dim] *= OUTLIER_SCALE - 4.0 * j
    return params


def value_and_grad(loss_fn, tree):
    """(loss, gradient tree) of ``loss_fn(tree)`` at the tree's values;
    leaves the loss does not reach get zero gradients, as under
    ``jax.grad``."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(tree)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(tree, leaves))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(tree, grads)


def train_steps(cfg: bert.BertConfig, params, src: SyntheticGLUE,
                steps: int, *, total_steps: Optional[int] = None,
                device=None, log=None, task_name: str = ""):
    """Adam with linear warmup + decay over ``total_steps`` (default
    ``steps``) and global-norm clipping at 1.0 (the outlier init needs it),
    on batches ``src.batch(BATCH, i)`` for i < ``steps``. Returns (params,
    per-step losses as a device tensor)."""
    dev = resolve_device(device)
    opt = adam_init(params)
    lr = linear_warmup_linear_decay(TRAIN_LR, total_steps or steps)
    losses = []
    for i in range(steps):
        batch = to_device(src.batch(BATCH, i), dev)
        loss, g = value_and_grad(
            lambda p: bert.loss_fn(cfg, p, batch), params)
        g, _ = clip_by_global_norm(g, 1.0)
        upd, opt = adam_update(g, opt, params, lr=lr)
        params = apply_updates(params, upd)
        losses.append(loss)
        if log and i % 50 == 0:
            log(f"  [{task_name}] step {i} loss {float(loss):.4f}")
    return params, torch.stack(losses) if losses else torch.zeros(0)


def train_task(task: GLUETaskConfig, *, steps: int = TRAIN_STEPS,
               seed: int = 0, log=None, device=None) -> dict:
    """Train (or load the cached) bench BERT for one task. Returns
    params."""
    dev = resolve_device(device)
    ckpt_dir = RESULTS_DIR / "bert_ckpts"
    os.makedirs(ckpt_dir, exist_ok=True)
    path = ckpt_dir / f"{task.name}_s{seed}.pt"
    if path.exists():
        return torch.load(path, map_location=dev)
    cfg = bench_cfg(task)
    params = init_with_outliers(cfg, seed, device=dev)
    params, _ = train_steps(cfg, params, _task_src(task), steps, device=dev,
                            log=log, task_name=task.name)
    torch.save(params, path)
    return params


@torch.no_grad()
def eval_task(task: GLUETaskConfig, params, ctx: Optional[QuantCtx] = None,
              device=None) -> float:
    """Task metric (0-100) on held-out synthetic dev data."""
    dev = resolve_device(device)
    cfg = bench_cfg(task)
    src = _task_src(task)
    preds, labels = [], []
    for i in range(EVAL_EXAMPLES // 64):
        b = src.batch(64, 100_000 + i)     # disjoint index range from train
        preds.append(bert.predict(cfg, params, to_device(b, dev), ctx=ctx))
        labels.append(b["labels"])
    return src.metric(torch.cat(preds).cpu().numpy(), np.concatenate(labels))


def calib_batches(task: GLUETaskConfig, n: int = 4, batch_size: int = 16,
                  device=None):
    dev = resolve_device(device)
    src = _task_src(task)
    return [to_device(src.batch(batch_size, 200_000 + i), dev)
            for i in range(n)]


def _forward(cfg):
    def fwd(p, b, ctx):
        return bert.classify(cfg, p, b["tokens"], type_ids=b.get("type_ids"),
                             pad_mask=b.get("pad_mask"), ctx=ctx)
    return fwd


def quantize_and_eval(task: GLUETaskConfig, params,
                      policy: QuantizationPolicy, adaround_ffn: bool = False,
                      device=None) -> float:
    """Full PTQ pipeline -> dev metric. ``adaround_ffn`` refines every
    layer's ``ffn/w_in`` with AdaRound (300 iterations, batches of 128) on
    that layer's calibration inputs, collected under the W8A8 activation
    policy: the reference collects them under ``policy``, whose FP32
    activations (Table 7's W4A32) leave ``ffn_in`` unobserved, so its
    AdaRound row never runs AdaRound."""
    dev = resolve_device(device)
    cfg = bench_cfg(task)
    batches = calib_batches(task, device=dev)
    fwd = _forward(cfg)
    adaround_sites = None
    if adaround_ffn:
        _, tensors = collect_ranges(fwd, params, batches, w8a8_policy())
        adaround_sites = {}
        for i, p in enumerate(params["layers"]):
            x_in = tensors.get(f"layer{i}/ffn_in")
            if x_in is not None:
                adaround_sites[f"layer{i}/ffn/w_in"] = \
                    (p["w_in"], x_in.reshape(-1, x_in.shape[-1]))
    with torch.no_grad():
        qm = ptq(fwd, params, batches, policy,
                 named_weights=bert.named_weight_sites(cfg, params),
                 adaround_sites=adaround_sites,
                 adaround_cfg=AdaRoundConfig(iterations=300, batch_size=128))
    if qm.adarounded_weights:
        params = tree_map(lambda x: x, params)      # new containers
        for site, w in qm.adarounded_weights.items():
            i = int(site.split("/")[0].removeprefix("layer"))
            params["layers"][i]["w_in"] = w
            # adarounded weights are pre-quantized: drop their weight state
            qm.weight_state.pop(site, None)
    return eval_task(task, params, qm.ctx(), device=dev)


def qat_finetune(task: GLUETaskConfig, params, policy: QuantizationPolicy,
                 *, steps: int = 80, lr_max: float = 1e-3, device=None,
                 losses: Optional[list] = None):
    """Paper §4 QAT: quantization params initialized from PTQ, weights and
    ranges fine-tuned jointly with STE. Returns (params, ctx_factory);
    ``losses`` (a list) collects each step's loss tensor."""
    dev = resolve_device(device)
    cfg = bench_cfg(task)
    batches = calib_batches(task, device=dev)
    with torch.no_grad():
        qm = ptq(_forward(cfg), params, batches, policy,
                 named_weights=bert.named_weight_sites(cfg, params))
    wstate = qm.weight_state
    src = _task_src(task)
    lr = linear_warmup_linear_decay(lr_max, steps)
    trainable = {"model": params, "quant": init_qat_params(qm.act_state,
                                                           wstate)}
    opt = adam_init(trainable)

    def loss(tr, batch):
        ctx = QuantCtx(policy=policy, mode=Mode.QAT, act_state=qm.act_state,
                       weight_state=wstate, qat_params=tr["quant"])
        return bert.loss_fn(cfg, tr["model"], batch, ctx=ctx)

    for i in range(steps):
        batch = to_device(src.batch(BATCH, 300_000 + i), dev)
        l, g = value_and_grad(lambda tr: loss(tr, batch), trainable)
        upd, opt = adam_update(g, opt, trainable, lr=lr)
        trainable = apply_updates(trainable, upd)
        if losses is not None:
            losses.append(l)

    def ctx_factory():
        return QuantCtx(policy=policy, mode=Mode.QAT, act_state=qm.act_state,
                        weight_state=wstate, qat_params=trainable["quant"])
    return trainable["model"], ctx_factory


def eval_qat(task, params, ctx_factory, device=None) -> float:
    return eval_task(task, params, ctx_factory(), device=device)


def cached_table(name: str, compute):
    """JSON-cache a table computation under ``RESULTS_DIR``."""
    os.makedirs(RESULTS_DIR, exist_ok=True)
    path = RESULTS_DIR / f"{name}.json"
    if path.exists():
        with open(path) as f:
            return json.load(f)
    result = compute()
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    return result


def table_name(base: str, tasks=None, labels=None) -> str:
    """A cache name for a table computed over a subset of its tasks or
    rows (the full table keeps ``base``)."""
    parts = [base] + [t.name for t in tasks or ()] + list(labels or ())
    return "__".join(re.sub(r"[^\w.-]+", "_", p) for p in parts)


def glue_average(scores: Dict[str, float]) -> float:
    return float(np.mean(list(scores.values())))
