"""Rank bodies of ``tests/test_torch_train_mesh.py``: functions that
``repro_torch.launch.mesh.run_ranks`` spawns on a CPU gloo group to train
under a rank mesh, returning logical (gathered) numpy arrays that the test
holds to the unsharded port and the reference. No JAX here (every rank
would import it)."""
import dataclasses
import os
import signal

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data import DataPipeline, LMTaskConfig, SyntheticLM, \
    shard_batch
from repro_torch.launch.mesh import remesh
from repro_torch.models import transformer as tfm
from repro_torch.optim import (adam_init, linear_warmup_linear_decay,
                               qadam_init, tree_leaves)
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import (gather_leaf, gather_logical,
                                           logical_params,
                                           make_opt_shardings,
                                           make_param_shardings, make_dist,
                                           param_shardings)
from repro_torch.runtime import (TrainLoopConfig, make_train_step,
                                 run_train_loop)

LR = 1e-3
SEED = 5


def wide(cfg):
    """Reduced gemma2-2b with a 4096 x 256 tied embedding: a leaf whose
    8-bit Adam moments are int8 (2^20 elements, last dim 256), cut over
    ``model`` on its rows and over ``data`` on its last dim."""
    return dataclasses.replace(cfg, vocab_size=4096, d_model=256)


def case_config(arch, variant):
    cfg = get_config(arch).reduced()
    return wide(cfg) if variant == "wide" else cfg


def _np(tree):
    """Copies of the leaves (the steps update params and moments in
    place)."""
    return [t.detach().cpu().numpy().copy() for t in tree_leaves(tree)]


def qat_ctx_factory(cfg, estimator, dev="cpu", grids=None):
    """QAT in the train graph (W8A8 fake-quant): every weight's symmetric
    8-bit per-tensor grid estimated each step by ``estimator`` ("minmax"
    or "mse"), the activation sites' grids calibrated once on the whole
    params of ``SEED`` (two batches of B 2 x T 16, the same on every rank
    and in the unsharded run). ``grids``, a list, receives (site, scale)
    of every weight grid fitted, in call order."""
    from repro_torch.core import Mode, QuantCtx, ptq
    from repro_torch.core import calibration as cal
    from repro_torch.core.quant_config import (QuantizationPolicy,
                                               QuantizerConfig,
                                               RangeEstimator)
    est = {"minmax": RangeEstimator.CURRENT_MINMAX,
           "mse": RangeEstimator.MSE}[estimator]
    pol = QuantizationPolicy(weight_default=QuantizerConfig(
        bits=8, symmetric=True, estimator=est))
    params = tfm.init_params(cfg, SEED, dtype=torch.float32, device=dev)
    rng = np.random.RandomState(3)
    calib = [{"tokens": torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (2, 16))).to(dev)} for _ in range(2)]
    act_state = ptq(lambda p, b, ctx: tfm.forward(cfg, p, b["tokens"],
                                                  ctx=ctx)[0],
                    params, calib, pol).act_state

    class Recorded(cal.QuantCtx):
        def fit_weight(self, site, w, qcfg):
            qp = super().fit_weight(site, w, qcfg)
            grids.append((site, float(qp.scale.detach())))
            return qp
    make = QuantCtx if grids is None else Recorded
    return lambda: make(policy=pol, mode=Mode.APPLY, act_state=act_state)


def run_steps(cfg, batches, dist=None, *, optimizer="adam",
              microbatches=1, dev="cpu", qat=None):
    """``len(batches)`` steps of ``make_train_step`` (``dist``: on this
    rank's slices of the same params, drawn from ``SEED``) in f32; per
    step the loss and gradient norm, the gradients before the update and
    the params and optimizer state after it, as logical numpy leaves.
    ``qat`` (a weight estimator of :func:`qat_ctx_factory`) trains with
    W8A8 fake-quant in the graph; each step's record then also holds the
    weight grids its ``loss_and_grads`` fitted (``grids``)."""
    params = tfm.init_params(cfg, SEED, dtype=torch.float32, device=dev)
    init = qadam_init if optimizer == "adam8bit" else adam_init
    p_sh = o_sh = None
    if dist is None:
        opt = init(params)
    else:
        params = make_param_shardings(params, dist)
        p_sh = param_shardings(cfg, params, dist)
        opt = (qadam_init(params, logical=logical_params(cfg))
               if optimizer == "adam8bit" else adam_init(params))
        o_sh = make_opt_shardings(opt, p_sh, dist)
    whole = (lambda t, s: t) if dist is None else gather_logical
    grids = []
    ctx = None if qat is None else qat_ctx_factory(cfg, qat, dev, grids)
    step = make_train_step(cfg, lr_schedule=linear_warmup_linear_decay(
        LR, 10), microbatches=microbatches, dist=dist, optimizer=optimizer,
        ctx_factory=ctx)
    out = []
    for toks in batches:
        batch = {"tokens": toks, "labels": toks}
        if dist is not None:
            batch = shard_batch(batch, dist, microbatches)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        grids.clear()
        _, grads = step.loss_and_grads(params, batch)
        fitted = list(grids)
        grads = _np(whole(grads, p_sh))
        params, opt, m = step(params, opt, batch)
        out.append({"loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"]),
                    "lr": float(m["lr"]), "grads": grads,
                    "params": _np(whole(params, p_sh)),
                    "opt": _np(whole(opt, o_sh)), "grids": fitted})
    return out


def step_scenarios(dist, dev, cases):
    """Every case of ``cases`` ({name: (mesh shape, arch, variant,
    optimizer, microbatches, batches[, qat estimator])}) on this rank, the
    meshes made from the spawn's in one order on every rank."""
    meshes = {tuple(dist.mesh.shape.values()): dist}
    got = {}
    for name, (shape, arch, variant, opt, mb, batches, *qat) in \
            cases.items():
        if shape not in meshes:
            axes = ("data", "model") if len(shape) == 2 else \
                ("pod", "data", "model")
            meshes[shape] = make_dist(remesh(dist.mesh, shape, axes))
        got[name] = run_steps(case_config(arch, variant), batches,
                              meshes[shape], optimizer=opt,
                              microbatches=mb, dev=dev,
                              qat=qat[0] if qat else None)
    return got


def unsharded_step(cfg, state, toks, *, optimizer="adam", microbatches=1,
                   dev="cpu", qat=None):
    """One unsharded ``make_train_step`` step from ``state`` (the logical
    (params, optimizer state) leaves a sharded run recorded, or None for
    the seed's initial state) on the batch ``toks``: the record of
    :func:`run_steps`."""
    from repro_torch.optim import tree_unflatten
    params = tfm.init_params(cfg, SEED, dtype=torch.float32, device=dev)
    opt = (qadam_init if optimizer == "adam8bit" else adam_init)(params)
    if state is not None:
        n = len(tree_leaves(params))
        leaves = [torch.from_numpy(a.copy()).to(dev) for a in state]
        params = tree_unflatten(params, leaves[:n])
        opt = tree_unflatten(opt, leaves[n:])
    grids = []
    ctx = None if qat is None else qat_ctx_factory(cfg, qat, dev, grids)
    step = make_train_step(cfg, lr_schedule=linear_warmup_linear_decay(
        LR, 10), microbatches=microbatches, optimizer=optimizer,
        ctx_factory=ctx)
    t = torch.from_numpy(toks).to(dev)
    batch = {"tokens": t, "labels": t}
    _, grads = step.loss_and_grads(params, batch)
    fitted = list(grids)
    grads = _np(grads)
    params, opt, m = step(params, opt, batch)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "lr": float(m["lr"]), "grads": grads, "params": _np(params),
            "opt": _np(opt), "grids": fitted}


def e2e_scenario(dist, dev, arch, toks, steps, microbatches):
    """The reference's multi-device end-to-end case on this rank:
    ``arch`` reduced in f32, placed, ``steps`` steps of Adam with
    ``microbatches`` on one batch (it overfits): the losses."""
    cfg = get_config(arch).reduced()
    params = make_param_shardings(tfm.init_params(
        cfg, 0, dtype=torch.float32, device=dev), dist)
    opt = adam_init(params)
    step = make_train_step(cfg, lr_schedule=linear_warmup_linear_decay(
        1e-3, 10), microbatches=microbatches, dist=dist)
    rows = shard_batch({"tokens": toks, "labels": toks}, dist, microbatches)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in rows.items()}
    losses = []
    for _ in range(steps):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    return losses


def _mesh_for(dist, shape, meshes):
    if shape not in meshes:
        axes = ("data", "model") if len(shape) == 2 else \
            ("pod", "data", "model")
        meshes[shape] = make_dist(remesh(dist.mesh, shape, axes))
    return meshes[shape]


def moe_block_scenarios(dist, dev, cases):
    """The port's MoE block under a mesh (``_moe_sharded`` on the rank's
    dp rows, the router and experts placed by the rules and gathered over
    the FSDP axis as the forward gathers a layer's leaves) for every case
    ({name: (MoEConfig fields, mesh shape, params, x, r)} whose shape is
    the spawn's): the value of sum(out * r) over the whole batch and,
    gathered, the output and the gradients of the router, the experts and
    x."""
    import types
    from repro_torch.models.moe import MoEConfig
    from repro_torch.parallel.sharding import (NamedSharding,
                                               make_param_specs)
    meshes = {tuple(dist.mesh.shape.values()): dist}
    got = {}
    for name, (kw, shape, p, x, r) in cases.items():
        d = _mesh_for(dist, shape, meshes)
        tree = {"moe": {k: torch.from_numpy(v).to(dev)
                        for k, v in p.items()}}
        specs = make_param_specs(tree, d)["moe"]
        placed = make_param_shardings(tree, d)["moe"]
        names = sorted(placed)
        leaves = [placed[k].detach().requires_grad_(True) for k in names]
        rows = shard_batch({"x": x, "r": r}, d)
        xl = torch.from_numpy(rows["x"]).to(dev).requires_grad_(True)
        dims = {k: tuple(i for i, e in enumerate(specs[k])
                         if e == d.fsdp_axis) for k in names}
        with torch.enable_grad():
            gathered = tfm._fsdp_gathered(dict(zip(names, leaves)), dims, d)
            out = tfm._moe_sharded(types.SimpleNamespace(moe=MoEConfig(**kw)),
                                   gathered, xl, d)
            loss = torch.sum(out * torch.from_numpy(rows["r"]).to(dev))
            grads = torch.autograd.grad(loss, leaves + [xl])
        value = coll.all_reduce_sum(loss.detach(), d, d.dp_axes)
        whole = {k: gather_leaf(g, NamedSharding(d.mesh, specs[k]))
                 for k, g in zip(names, grads)}
        whole["x"] = coll.all_gather(grads[-1], d, 0, d.dp_axes)
        whole["out"] = coll.all_gather(out.detach(), d, 0, d.dp_axes)
        got[name] = (float(value),
                     {k: v.detach().cpu().numpy() for k, v in whole.items()})
    return got


def _loop(cfg, dist, dev, total, ckdir, lines, hook=None, resume=True):
    """``run_train_loop`` on this rank: reduced ``cfg`` in f32 from the
    seed, placed, Adam, the reference's synthetic LM stream (B 4 x T 16);
    ``hook(step_index)`` runs after each step. Returns (the loop's
    result, its shardings)."""
    params = make_param_shardings(
        tfm.init_params(cfg, SEED, dtype=torch.float32, device=dev), dist)
    opt = adam_init(params)
    p_sh = param_shardings(cfg, params, dist)
    shardings = (p_sh, make_opt_shardings(opt, p_sh, dist))
    step = make_train_step(cfg, lr_schedule=linear_warmup_linear_decay(
        LR, 10), dist=dist)
    calls = [0]

    def step_fn(p, o, b):
        out = step(p, o, b)
        calls[0] += 1
        if hook is not None:
            hook(calls[0])
        return out
    src = SyntheticLM(LMTaskConfig(vocab_size=cfg.vocab_size, seq_len=16),
                      seed=0)

    def put(batch):
        rows = shard_batch({k: batch[k] for k in ("tokens", "labels")},
                           dist)
        return {k: torch.from_numpy(v).to(dev) for k, v in rows.items()}
    out = run_train_loop(step_fn, params, opt, DataPipeline(src, 4, seed=0),
                         TrainLoopConfig(total_steps=total,
                                         checkpoint_every=100,
                                         checkpoint_dir=ckdir, log_every=1,
                                         resume=resume),
                         put_batch=put, shardings=shardings,
                         log=lines.append)
    return out, shardings


def checkpoint_scenarios(dist, dev, root):
    """On this rank of reduced gemma2-2b: 4 straight steps of the loop;
    2 steps checkpointed under ``root``/run and a resumed run to 4; a
    5-step run under ``root``/sigterm in which rank 1 sends itself
    SIGTERM after its second step. Returns the logical params after the
    straight and the resumed runs, the logical (params, opt) the resumed
    run started from, the SIGTERM run's final step and every run's log
    lines."""
    cfg = get_config("gemma2-2b").reduced()
    lines = {k: [] for k in ("straight", "first", "resumed", "sigterm")}
    straight, sh = _loop(cfg, dist, dev, 4, None, lines["straight"])
    first, _ = _loop(cfg, dist, dev, 2, os.path.join(root, "run"),
                     lines["first"])
    saved = _np(gather_logical((first["params"], first["opt_state"]), sh))
    resumed, _ = _loop(cfg, dist, dev, 4, os.path.join(root, "run"),
                       lines["resumed"])

    def kill(i):
        if dist.mesh.rank == 1 and i == 2:
            os.kill(os.getpid(), signal.SIGTERM)
    stopped, _ = _loop(cfg, dist, dev, 5, os.path.join(root, "sigterm"),
                       lines["sigterm"], hook=kill)
    return {"straight": _np(gather_logical(straight["params"], sh[0])),
            "resumed": _np(gather_logical(resumed["params"], sh[0])),
            "saved": saved, "sigterm_step": stopped["step"],
            "lines": lines}


def restore_scenarios(dist, dev, ckdir, step, shapes):
    """The checkpoint at ``step`` under ``ckdir`` restored onto each mesh
    of ``shapes`` (reduced gemma2-2b's params and Adam state as this rank's
    slices), gathered back: a list of logical leaves per shape."""
    from repro_torch.checkpoint import Checkpointer
    cfg = get_config("gemma2-2b").reduced()
    meshes = {tuple(dist.mesh.shape.values()): dist}
    got = {}
    for shape in shapes:
        d = _mesh_for(dist, shape, meshes)
        params = make_param_shardings(
            tfm.init_params(cfg, 1, dtype=torch.float32, device=dev), d)
        opt = adam_init(params)
        p_sh = param_shardings(cfg, params, d)
        sh = (p_sh, make_opt_shardings(opt, p_sh, d))
        tree, meta = Checkpointer(ckdir).restore((params, opt), step=step,
                                                 shardings=sh)
        got[shape] = (_np(gather_logical(tree, sh)), meta["step"],
                      [tuple(t.shape) for t in tree_leaves(tree)])
    return got


def run_all(dist, dev, jobs):
    """Each (name of a function of this module, args) of ``jobs`` on this
    rank, in order: one spawn runs every scenario of a world size."""
    return [globals()[name](dist, dev, *args) for name, args in jobs]


def assert_step_close(rec, want, optimizer, i, tol=1e-5):
    """Step ``i`` of a sharded run (``rec``) against the unsharded step
    from the same state (``want``), the bounds of
    ``tests/test_torch_train_mesh.py``; returns the count of updated
    params past 1e-6 of the unsharded ones and the count of all params
    (None where they are not held: 8-bit Adam after its first step)."""
    def rel(a, b):
        b = np.asarray(b, np.float64)
        d = np.abs(np.asarray(a, np.float64) - b)
        return float(d.max()) / max(float(np.abs(b).max()), 1e-30) \
            if b.size else 0.0
    for k in ("loss", "grad_norm"):
        assert abs(rec[k] - want[k]) <= tol * abs(want[k]), (i, k)
    assert rec["lr"] == want["lr"], (i, rec["lr"], want["lr"])
    for a, b in zip(rec["grads"], want["grads"]):
        assert a.shape == b.shape
        assert rel(a, b) <= tol, (i, rel(a, b))
    flips = n_int8 = 0
    for a, b in zip(rec["opt"], want["opt"]):
        if a.dtype == np.int8:
            d = np.abs(a.astype(np.int32) - b)
            assert int(d.max()) <= 1
            flips += int((d > 0).sum())
            n_int8 += d.size
        elif a.dtype == np.int32:
            assert np.array_equal(a, b)
        else:
            assert rel(a, b) <= tol, (i, rel(a, b))
    assert flips <= 1e-3 * max(n_int8, 1), (i, flips, n_int8)
    assert (n_int8 > 0) == (optimizer == "adam8bit")
    if i > 0 and optimizer == "adam8bit":
        return None
    # the step's own lr: a sign flip of a near-zero gradient moves an
    # element by 2 x lr (plus the rounding of each side's sum); an update
    # not applied, or applied with the wrong sign, moves nearly every
    # element by lr or more, so the elements past 1e-6 are bounded too
    past = n = 0
    for a, b in zip(rec["params"], want["params"]):
        d = np.abs(a.astype(np.float64) - b)
        bound = 2 * want["lr"] + 2 * np.spacing(np.abs(b).astype(np.float32))
        assert (d <= bound).all(), (i, float(d.max()), want["lr"])
        past += int((d > 1e-6).sum())
        n += d.size
    assert past <= 1e-4 * n, (i, past, n)
    return past, n
