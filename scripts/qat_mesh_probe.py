#!/usr/bin/env python3
"""Where a QAT step under a rank mesh parts from the unsharded one, on one
card: ``chip_smoke.py`` phase 50's (d) set-up (gemma2-2b at published
width, ``TRAIN_MESH_DEPTH`` layers, f32, B 4 x ``TRAIN_MESH_T``, 4 ranks
as (data, model) = (2, 2) on ``cuda:0`` over gloo), in three variants of
the fake-quant ctx, each run unsharded first and then on the ranks:

* ``w8a32``: weights only, every weight's grid fitted by min-max at each
  read (the phase's own ctx, ``chip_smoke._qat_ctx``);
* ``w8a32-detached``: the same with the grid detached from autograd, so
  no gradient flows through the grid into the element holding a weight's
  extreme;
* ``w8a8``: the weights as ``w8a32`` and 8-bit activation sites on grids
  calibrated on the whole params (two 2 x 16 batches), whose
  straight-through clip masks follow the activations' values.

Prints per variant and rank the loss against the unsharded one, each
gradient leaf's largest difference over the leaf's max |g|, split into
the elements holding a weight's extreme and the others, and the card's
name and power limit.

    python3 scripts/qat_mesh_probe.py          # all three variants
    python3 scripts/qat_mesh_probe.py w8a8     # one of them
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO))

VARIANTS = ("w8a32", "w8a32-detached", "w8a8")


def ctx_factory(variant, act_state):
    """The fake-quant ctx factory of ``variant`` (module docstring)."""
    import dataclasses

    import chip_smoke as cs
    from repro_torch.core import Mode, QuantCtx
    from repro_torch.core.quant_config import A8_DEFAULT
    from repro_torch.core.quantizer import QuantParams
    pol = cs._qat_ctx()().policy
    if variant == "w8a8":
        pol = dataclasses.replace(pol, act_default=A8_DEFAULT)

    class Detached(QuantCtx):
        def fit_weight(self, site, w, qcfg):
            qp = super().fit_weight(site, w, qcfg)
            return QuantParams(qp.scale.detach(), qp.zero_point.detach(),
                               None)
    make = Detached if variant == "w8a32-detached" else QuantCtx
    return lambda: make(policy=pol, mode=Mode.APPLY, act_state=act_state)


def calibrated(cfg, dev):
    """Activation grids calibrated on the whole params of the phase's seed
    (the ``w8a8`` variant's)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core import ptq
    from repro_torch.models import transformer as tfm
    params = tfm.init_params(cfg, cs.TRAIN_MESH_SEED, dtype=torch.float32,
                             device=dev)
    rng = np.random.RandomState(cs.TRAIN_MESH_SEED + 1)
    calib = [{"tokens": torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (2, 16))).to(dev)} for _ in range(2)]
    pol = ctx_factory("w8a8", {})().policy
    with torch.no_grad():
        return ptq(lambda p, b, ctx: tfm.forward(cfg, p, b["tokens"],
                                                 ctx=ctx)[0],
                   params, calib, pol).act_state


def loss_and_grads(cfg, dev, variant, act_state, dist=None):
    """One ``loss_and_grads`` of the phase's batch: (loss, gradient
    leaves, param leaves), this rank's slices under ``dist``."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.data import shard_batch
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import tree_leaves
    from repro_torch.parallel.sharding import make_param_shardings
    from repro_torch.runtime import make_train_step
    T = cs.TRAIN_MESH_T
    toks = np.random.RandomState(cs.TRAIN_MESH_SEED).randint(
        0, cfg.vocab_size, (4, T)).astype(np.int32)
    rows = {"tokens": toks, "labels": toks}
    if dist is not None:
        rows = shard_batch(rows, dist)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in rows.items()}
    params = tfm.init_params(cfg, cs.TRAIN_MESH_SEED, dtype=torch.float32,
                             device=dev)
    if dist is not None:
        params = make_param_shardings(params, dist)
    step = make_train_step(cfg, lr_schedule=cs.TRAIN_MESH_LR, dist=dist,
                           ctx_factory=ctx_factory(variant, act_state))
    loss, grads = step.loss_and_grads(params, batch)
    return float(loss), tree_leaves(grads), tree_leaves(params)


def rank(dist, dev, cfg, path, variants):
    """Each variant on this rank against the unsharded record at
    ``path``: (loss, worst difference off the extremes, worst on them, how
    many extreme elements pass 1e-5) of the leaves' max |g|."""
    import torch

    from repro_torch.optim import tree_leaves
    from repro_torch.parallel.sharding import cut_leaf, param_shardings
    oracle = torch.load(path, map_location="cpu", weights_only=False)
    out = {}
    for v in variants:
        o = oracle[v]
        acts = {k: type(qp)(*(None if t is None else t.to(dev) for t in qp))
                for k, qp in o["acts"].items()}
        loss, grads, params = loss_and_grads(cfg, dev, v, acts, dist)
        shs = tree_leaves(param_shardings(cfg, _tree(params, cfg), dist))
        off = on = 0.0
        past = 0
        for g, p, sh, want, gmax, (m, n_hit) in zip(
                grads, params, shs, o["grads"], o["gmax"], o["extremes"]):
            d = (g - cut_leaf(want, sh).to(dev)).abs() / max(gmax, 1e-30)
            ext = torch.zeros_like(d, dtype=torch.bool)
            if n_hit <= 2 * m.numel():
                ext = p.detach().abs() == m.to(dev).reshape(
                    m.shape + (1,) * (p.dim() - m.dim()))
            off = max(off, float(torch.where(ext, 0.0, d).max()))
            on = max(on, float(torch.where(ext, d, 0.0).max()))
            past += int((ext & (d > 1e-5)).sum())
        out[v] = (loss, off, on, past)
    return out


def _tree(leaves, cfg):
    """The param tree of ``cfg`` with ``leaves`` (in ``tree_leaves``
    order) in its place."""
    import torch

    from repro_torch.models import transformer as tfm
    from repro_torch.optim import tree_unflatten
    return tree_unflatten(tfm.init_params(cfg, 0, dtype=torch.float32,
                                          device="meta"), leaves)


def main(argv=None):
    import torch

    import chip_smoke as cs
    from repro_torch.launch.mesh import run_ranks
    argv = sys.argv[1:] if argv is None else argv
    variants = tuple(argv) or VARIANTS
    if not torch.cuda.is_available():
        print("qat_mesh_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(f"[device] {smi.stdout.strip()}")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    path = REPO / "build" / "qat_mesh_probe.pt"
    path.parent.mkdir(exist_ok=True)
    with cs._train_config(cs.TRAIN_MESH_DEPTH) as cfg:
        record = {}
        for v in variants:
            acts = calibrated(cfg, dev) if v == "w8a8" else {}
            loss, grads, params = loss_and_grads(cfg, dev, v, acts)
            leaves = [g.cpu() for g in grads]
            record[v] = {
                "loss": loss, "grads": leaves,
                "gmax": [float(g.abs().max()) for g in leaves],
                "extremes": cs._extremes(_tree(params, cfg)),
                "acts": {k: type(qp)(*(None if t is None else t.cpu()
                                       for t in qp))
                         for k, qp in acts.items()}}
            del grads, params
        torch.save(record, path)
        torch.cuda.empty_cache()
        got = run_ranks(rank, 4, (cfg, str(path), variants),
                        shape=cs.TRAIN_MESH_SHAPE)
    for v in variants:
        print(f"[qat-probe] {v}: unsharded loss {record[v]['loss']:.6f}")
        for r, res in enumerate(got):
            loss, off, on, past = res[v]
            print(f"[qat-probe] {v}: rank {r}: loss {loss:.6f} "
                  f"({abs(loss - record[v]['loss']) / record[v]['loss']:.3g}"
                  f" relative); gradients off the elements holding a "
                  f"weight's extreme within {off:.3g} of their leaf's max, "
                  f"on them {on:.3g} ({past} past 1e-5)")
    path.unlink()
    return 0


if __name__ == "__main__":
    sys.exit(main())
