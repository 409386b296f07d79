"""Training under a rank mesh in the port (``make_train_step(dist=)``,
FSDP gathers over ``data``, tensor-parallel gradients over ``model``,
sharded Adam and 8-bit Adam, ``Checkpointer`` with ``shardings``,
``shard_batch``, ``train --mesh``) against the unsharded port and the
reference, on the CPU (gloo ranks: one spawn a world size of 2, 4 and 8).

* Steps: reduced gemma2-2b in f32 on (1, 2), (2, 1) and (2, 2), Adam and
  8-bit Adam (the 4096 x 256 embedding variant, whose moments are int8),
  1 and 2 microbatches, 2 steps on B 4 x T 16. Each step is held to the
  port's unsharded step from the same state (the state the sharded run
  recorded before it): loss and gradient norm within 1e-5 relative, every
  gradient leaf (gathered) within 1e-5 of its max, the updated params
  within 2 x the step's lr (Adam's bound on one step: ``g / (|g| + eps)``
  of a near-zero gradient swings on float noise; at most 1e-4 of the
  elements past 1e-6, so an update left out or of the wrong sign fails),
  f32 moments within 1e-5 of each leaf's max, int8 moments at
  most 1 LSB apart on at most 1e-3 of the payload (rounding ties). 8-bit
  Adam's params are held after its first step only: its second update
  divides dequantized moments, and an element whose int8 second moment is
  0 in a row with a far larger maximum takes an update of up to m / eps,
  which float noise in a near-zero gradient swings by far more than lr
  (the reference's algorithm; ``tests/test_torch_train.py`` holds it the
  same way). Every rank returns the same logical arrays.
* QAT (``ctx_factory``: W8A8 fake-quant, every weight's grid refitted
  each step by min-max or MSE): one spawn's (2, 2) mesh, 2 f32 steps, each
  within the float steps' bounds of the unsharded QAT step, the loss and
  gradient norm within 1e-6 relative, every weight grid equal.
* The reference's multi-device case: reduced qwen3-moe-235b on (2, 2, 2)
  ("pod", "data", "model"), 3 steps of 2 microbatches, a falling loss.
* The MoE block under (2, 2) and (2, 2, 2) against the reference's
  ``_moe_sharded`` under ``jax.value_and_grad`` (8 forced host devices, a
  subprocess): value and every gradient within 1e-5 of its max, at the
  config's capacity (no drops: also within 1e-5 of the unsharded
  ``moe_apply``) and at ``capacity_factor=1.0, min_capacity=1``, where
  each dp shard's routing drops rows and the function is not the
  unsharded one.
* Specs: the optimizer state's and the batch's against the reference's
  ``make_opt_shardings`` / ``qadam_shardings`` / ``shard_batch`` on
  abstract meshes.
* Checkpoints: saved on (2, 2), restored bit for bit on (1, 2), (2, 1)
  and one device; 2 + 2 steps with a resume bit-equal to 4 straight ones;
  a SIGTERM to one rank checkpoints every rank and deadlocks none.
* The launcher: ``--mesh 1x2`` (the reduced config through a patched
  ``get_config``) and ``--reduced --mesh`` (no mesh, as the reference).
"""
import dataclasses
import os
import subprocess
import sys
import tempfile
import textwrap
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipeline
from repro.models import transformer as jtfm
from repro.optim.adam import adam_init as jadam_init
from repro.optim.quantized_adam import qadam_init as jqadam_init
from repro.optim.quantized_adam import qadam_shardings as jqadam_shardings
from repro.parallel import sharding as jsh
from repro.configs import get_config as jget_config
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data import DrawnBatches, LMTaskConfig, SyntheticLM, \
    shard_batch
from repro_torch.launch import train
from repro_torch.launch.mesh import AbstractMesh, RankMesh, run_ranks
from repro_torch.optim.quantized_adam import qadam_shardings
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.optim import adam_init, qadam_init, tree_leaves
from repro_torch.parallel import sharding as sh

import torch_train_ranks as ranks

CPU = "cpu"
TOL = 1e-5
STEPS = 2
MESHES2 = ((1, 2), (2, 1))
OPTS = (("adam", "base"), ("adam8bit", "wide"))


def _batches(variant, seed):
    cfg = ranks.case_config("gemma2-2b", variant)
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, (4, 16)).astype(np.int32)
            for _ in range(STEPS)]


def _step_cases(shapes):
    return {f"{'x'.join(map(str, s))}-{opt}-mb{mb}":
            (s, "gemma2-2b", variant, opt, mb, _batches(variant, 7 + mb))
            for s in shapes for opt, variant in OPTS for mb in (1, 2)}


STEP_CASES = {**_step_cases(MESHES2), **_step_cases([(2, 2)])}
# QAT in the train graph on (2, 2): W8A8 fake-quant, every weight's grid
# refitted each step by min-max or MSE, the activations' grids calibrated
QAT_CASES = {f"2x2-qat-{est}": ((2, 2), "gemma2-2b", "base", "adam", 1,
                                _batches("base", 8), est)
             for est in ("minmax", "mse")}

MOE_D = get_config("qwen3-moe-235b").reduced().d_model


def _moe_kw(**over):
    m = get_config("qwen3-moe-235b").reduced().moe
    kw = dict(num_experts=m.num_experts, top_k=m.top_k, d_ff=m.d_ff,
              capacity_factor=m.capacity_factor, activation=m.activation,
              norm_topk=m.norm_topk, min_capacity=m.min_capacity)
    kw.update(over)
    return kw


MOE_CAPS = {"capacity": _moe_kw(),
            "drops": _moe_kw(capacity_factor=1.0, min_capacity=1)}


def _moe_case(shape, kw, seed):
    rng = np.random.RandomState(seed)
    e, f, d = kw["num_experts"], kw["d_ff"], MOE_D
    p = {"router": rng.normal(0, d ** -0.5, (d, e)),
         "w_gate": rng.normal(0, d ** -0.5, (e, d, f)),
         "w_up": rng.normal(0, d ** -0.5, (e, d, f)),
         "w_out": rng.normal(0, f ** -0.5, (e, f, d))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(0, 1, (4, 16, d)).astype(np.float32)
    r = rng.normal(0, 1, (4, 16, d)).astype(np.float32)
    return kw, shape, p, x, r


MOE_CASES = {f"{'x'.join(map(str, s))}-{cap}": _moe_case(s, kw, i)
             for i, (s, (cap, kw)) in enumerate(
                 (s, c) for s in ((2, 2), (2, 2, 2))
                 for c in MOE_CAPS.items())}

REF_MOE = textwrap.dedent("""
    import os, sys, types
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from repro.models import moe as jmoe
    from repro.models import transformer as jtfm
    from repro.parallel import make_dist

    assert len(jax.devices()) == 8, jax.devices()
    src = np.load(sys.argv[1], allow_pickle=True)
    got = {}
    for name, (kw, shape) in src["spec"].item().items():
        axes = ("data", "model") if len(shape) == 2 else \\
            ("pod", "data", "model")
        devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
        dist = make_dist(Mesh(devs, axes))
        cfg = types.SimpleNamespace(moe=jmoe.MoEConfig(**kw))
        p = {k: jnp.asarray(src[name + "/" + k])
             for k in ("router", "w_gate", "w_up", "w_out")}
        x, r = jnp.asarray(src[name + "/x"]), jnp.asarray(src[name + "/r"])

        def f(p, x, r):
            return jnp.sum(jtfm._moe_sharded(cfg, p, x, dist) * r)
        v, (gp, gx, gr) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1, 2)))(p, x, r)
        got[name + "/value"] = np.asarray(v)
        for k, g in gp.items():
            got[name + "/" + k] = np.asarray(g)
        got[name + "/x"] = np.asarray(gx)
        got[name + "/out"] = np.asarray(gr)    # d value / d r
    np.savez(sys.argv[2], **got)
""")


def _start_reference(tmp):
    """The reference's ``_moe_sharded`` under ``jax.value_and_grad`` for
    every MoE case, in a subprocess with 8 forced host devices; returns a
    function that waits for it and loads {case: (value, grads)}."""
    src, dst = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
    flat = {"spec": np.array({n: (c[0], c[1]) for n, c in MOE_CASES.items()},
                             dtype=object)}
    for name, (_, _, p, x, r) in MOE_CASES.items():
        flat.update({f"{name}/{k}": v for k, v in p.items()})
        flat[f"{name}/x"], flat[f"{name}/r"] = x, r
    np.savez(src, **flat)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(Path(__file__).resolve().parent.parent / "src")]
        + [x for x in env.get("PYTHONPATH", "").split(os.pathsep) if x])
    proc = subprocess.Popen([sys.executable, "-c", REF_MOE, src, dst],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)

    def wait():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-4000:]
        with np.load(dst) as z:
            return {n: (float(z[n + "/value"]),
                        {k: z[f"{n}/{k}"] for k in ("router", "w_gate",
                                                     "w_up", "w_out", "x",
                                                     "out")})
                    for n in MOE_CASES}
    return wait


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the module (and for each spawned rank)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spawn(world, shape, axes, jobs):
    return run_ranks(ranks.run_all, world, (jobs,), device=CPU, threads=1,
                     shape=shape, axes=axes)


@pytest.fixture(scope="module")
def runs():
    """One spawn a world size: 4 ranks on (2, 2) (steps, the MoE block,
    checkpoints), then 2 on (1, 2) (steps on (1, 2) and (2, 1), the (2, 2)
    checkpoint restored on both) beside 8 on (2, 2, 2) (the reference's
    qwen3-moe case, the MoE block), while a subprocess runs the
    reference's sharded MoE."""
    on = lambda shape: {k: v for k, v in STEP_CASES.items()  # noqa: E731
                        if (v[0] == (2, 2)) == (shape == (2, 2))}
    moe_on = lambda n: {k: v for k, v in MOE_CASES.items()  # noqa: E731
                        if len(v[1]) == n}
    qwen = get_config("qwen3-moe-235b").reduced()
    e2e_toks = np.random.RandomState(1).randint(
        0, qwen.vocab_size, (8, 16)).astype(np.int32)
    with tempfile.TemporaryDirectory() as tmp:
        wait = _start_reference(tmp)
        w4 = _spawn(4, (2, 2), ("data", "model"), [
            ("step_scenarios", ({**on((2, 2)), **QAT_CASES},)),
            ("moe_block_scenarios", (moe_on(2),)),
            ("checkpoint_scenarios", (tmp,))])
        got8 = []
        t8 = threading.Thread(target=lambda: got8.append(_spawn(
            8, (2, 2, 2), ("pod", "data", "model"), [
                ("e2e_scenario", ("qwen3-moe-235b", e2e_toks, 3, 2)),
                ("moe_block_scenarios", (moe_on(3),))])))
        t8.start()
        try:
            w2 = _spawn(2, (1, 2), ("data", "model"), [
                ("step_scenarios", (on((1, 2)),)),
                ("restore_scenarios", (os.path.join(tmp, "run"), 2,
                                       [(1, 2), (2, 1)]))])
            one, meta = Checkpointer(os.path.join(tmp, "run")).restore(
                _unsharded_state(), step=2)
            ckpt = {"one_device": [t.numpy() for t in tree_leaves(one)],
                    "meta_step": meta["step"],
                    "steps": Checkpointer(os.path.join(tmp, "run"))
                    .all_steps(),
                    "sigterm_steps": Checkpointer(os.path.join(
                        tmp, "sigterm")).all_steps()}
        finally:
            t8.join(timeout=600)
        ref = wait()
    assert not t8.is_alive() and got8, "the 8 ranks did not report"
    per_rank = {name: [r[0][name] for r in (w4 if case[0] == (2, 2)
                                            else w2)]
                for name, case in {**STEP_CASES, **QAT_CASES}.items()}
    return dict(w4=w4, w2=w2, w8=got8[0], ref=ref, ckpt=ckpt,
                steps={k: v[0] for k, v in per_rank.items()},
                per_rank=per_rank)


def _unsharded_state():
    cfg = get_config("gemma2-2b").reduced()
    params = tfm.init_params(cfg, 1, dtype=torch.float32, device=CPU)
    return params, adam_init(params)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    d = np.abs(np.asarray(got, np.float64) - want)
    return float(d.max()) / max(float(np.abs(want).max()), 1e-30) \
        if want.size else 0.0


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_sharded_step_matches_the_unsharded_step(runs, name):
    """Each step of the case against the unsharded step from the state the
    sharded run held before it (the module docstring's bounds)."""
    shape, arch, variant, opt, mb, batches = STEP_CASES[name]
    cfg = ranks.case_config(arch, variant)
    got = runs["steps"][name]
    state = None
    for i, (rec, toks) in enumerate(zip(got, batches)):
        want = ranks.unsharded_step(cfg, state, toks, optimizer=opt,
                                    microbatches=mb)
        past = ranks.assert_step_close(rec, want, opt, i, TOL)
        if past is not None:
            print(f"[{name}] step {i + 1}: {past[0]} of {past[1]} params "
                  f"beyond 1e-6 of the unsharded step (within 2 x lr "
                  f"{want['lr']:g}; at most 1e-4 of them)")
        state = rec["params"] + rec["opt"]


@pytest.mark.parametrize("name", list(QAT_CASES))
def test_sharded_qat_step_matches_the_unsharded_qat_step(runs, name):
    """QAT under a mesh (``make_train_step(dist=, ctx_factory=)``): each
    f32 step against the unsharded QAT step from the same state, within
    the bounds of the float steps, the loss and gradient norm within 1e-6
    relative; every weight grid the step fitted (the remat's refits
    included, in call order) equals the unsharded step's."""
    shape, arch, variant, opt, mb, batches, est = QAT_CASES[name]
    cfg = ranks.case_config(arch, variant)
    state = None
    for i, (rec, toks) in enumerate(zip(runs["steps"][name], batches)):
        want = ranks.unsharded_step(cfg, state, toks, qat=est)
        ranks.assert_step_close(rec, want, opt, i, TOL)
        for k in ("loss", "grad_norm"):
            assert abs(rec[k] - want[k]) <= 1e-6 * abs(want[k]), (i, k)
        # the forward's 7 weights a layer and the head, and the layers
        # again where the backward recomputes them (remat)
        assert len(want["grids"]) == 2 * 7 * cfg.num_layers + 1
        assert rec["grids"] == want["grids"], i
        state = rec["params"] + rec["opt"]


@pytest.mark.parametrize("name", list(STEP_CASES) + list(QAT_CASES))
def test_every_rank_holds_the_same_logical_state(runs, name):
    """The gathered gradients, params and moments of every rank of the
    case's mesh are the same bits."""
    per_rank = runs["per_rank"][name]
    for other in per_rank[1:]:
        for a, b in zip(other, per_rank[0]):
            for k in ("grads", "params", "opt"):
                assert all(np.array_equal(x, y) for x, y in zip(a[k], b[k]))


def test_qwen3_moe_trains_on_a_2x2x2_mesh(runs):
    """The reference's multi-device case on the port: reduced qwen3-moe,
    (pod, data, model) = (2, 2, 2), 2 microbatches, 3 steps on one batch:
    finite losses, falling, the same on every rank."""
    losses = [r[0] for r in runs["w8"]]
    assert all(l == losses[0] for l in losses)
    assert all(np.isfinite(losses[0])) and losses[0][-1] < losses[0][0]


def _l1(out, r):
    """The scale of sum(out * r): the sum of its terms' magnitudes (the
    sum itself cancels)."""
    return float(np.abs(np.asarray(out, np.float64) * r).sum())


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_moe_block_matches_the_references_sharded_moe(runs, name):
    """The port's MoE block under a data axis: its output and the
    gradients of sum(out * r) (the router, the experts and x, gathered)
    within 1e-5 of their max of the reference's ``_moe_sharded`` under
    ``jax.value_and_grad``, the value within 1e-5 of its terms' scale."""
    world = "w4" if len(MOE_CASES[name][1]) == 2 else "w8"
    value, grads = runs[world][0][1][name]
    rv, rg = runs["ref"][name]
    r = MOE_CASES[name][4]
    assert abs(value - rv) <= TOL * _l1(rg["out"], r)
    for k, g in rg.items():
        assert grads[k].shape == g.shape, k
        assert _rel(grads[k], g) <= TOL, (k, _rel(grads[k], g))
    for other in runs[world][1:]:
        v, g = other[1][name]
        assert v == value and all(np.array_equal(g[k], grads[k])
                                  for k in g)


@pytest.mark.parametrize("shape", ["2x2", "2x2x2"])
def test_moe_drops_make_the_sharded_block_another_function(runs, shape):
    """At the config's capacity nothing drops and the sharded block equals
    the unsharded ``moe_apply`` within 1e-5 of max|out|; with capacity
    factor 1 each dp shard drops rows of its own routing, and both
    packages' sharded outputs part from the unsharded one by more than
    1e-2 of max|out|."""
    world = "w4" if shape == "2x2" else "w8"
    for cap in MOE_CAPS:
        name = f"{shape}-{cap}"
        kw, _, p, x, r = MOE_CASES[name]
        un = moe.moe_apply({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x).reshape(-1, MOE_D),
                           moe.MoEConfig(**kw)).reshape(x.shape).numpy()
        got = runs[world][0][1][name][1]["out"]
        ref = runs["ref"][name][1]["out"]
        if cap == "capacity":
            assert _rel(got, un) <= TOL and _rel(ref, un) <= TOL
        else:
            assert _rel(got, un) > 1e-2 and _rel(ref, un) > 1e-2


MESH_SPECS = [((2, 2), ("data", "model")), ((1, 2), ("data", "model")),
              ((2, 1), ("data", "model")), ((16, 16), ("data", "model")),
              ((2, 2, 2), ("pod", "data", "model"))]


def _norm(spec):
    return sh._finish(tuple(spec))


@pytest.mark.parametrize("shape,axes", MESH_SPECS,
                         ids=["x".join(map(str, s)) for s, _ in MESH_SPECS])
@pytest.mark.parametrize("arch,variant", [("gemma2-2b", "base"),
                                          ("gemma2-2b", "wide"),
                                          ("qwen3-moe-235b", "base")])
def test_opt_specs_match_the_reference(shape, axes, arch, variant):
    """``make_opt_shardings`` (Adam) and the 8-bit state's shardings
    (``qadam_shardings``: the scales without the last entry) on abstract
    meshes, leaf by leaf, equal the reference's over the same logical
    params; the step counter replicated."""
    cfg = ranks.case_config(arch, variant)
    jcfg = jget_config(arch).reduced()
    if variant == "wide":
        jcfg = dataclasses.replace(jcfg, vocab_size=cfg.vocab_size,
                                   d_model=cfg.d_model)
    jdist = jsh.make_dist(jsh.make_abstract_mesh(shape, axes))
    jparams = jax.eval_shape(lambda: jtfm.init_params(
        jcfg, jax.random.PRNGKey(0), dtype=jnp.float32))
    jps = jsh.make_param_shardings(jparams, jdist)
    dist = sh.make_dist(AbstractMesh(shape, axes))
    ps = sh.param_shardings(cfg, None, dist)
    logical = sh.logical_params(cfg)
    # Adam
    jos = jsh.make_opt_shardings(jax.eval_shape(jadam_init, jparams), jps,
                                 jdist)
    os_ = sh.make_opt_shardings(adam_init(logical), ps, dist)
    want = [_norm(s.spec) for s in jax.tree.leaves(jos)]
    got = [_norm(s.spec) for s in tree_leaves(os_)]
    assert got == want and got[0] == ()
    # 8-bit Adam
    jq = jax.eval_shape(jqadam_init, jparams)
    for_leaf = jqadam_shardings(jps)
    is_m = lambda x: isinstance(x, dict) and "q" in x  # noqa: E731
    jq_sh = [for_leaf(s) if is_m(m) else s for s, m in zip(
        jax.tree.leaves(jps), jax.tree.leaves(jq.mu, is_leaf=is_m))]
    want = [_norm(s.spec) for s in jax.tree.leaves(jq_sh)]
    q = qadam_init(logical, logical)
    got = [_norm(s.spec) for s in tree_leaves(
        sh.make_opt_shardings(q, ps, dist).mu)]
    assert got == want
    assert (variant == "wide") == any(is_m(m) for m in jax.tree.leaves(
        jq.mu, is_leaf=is_m))


@pytest.mark.parametrize("shape,axes", MESH_SPECS[:3] + MESH_SPECS[4:],
                         ids=["2x2", "1x2", "2x1", "2x2x2"])
def test_shard_batch_cuts_the_references_rows(monkeypatch, shape, axes):
    """``shard_batch`` places each leaf by the reference's spec (its
    ``shard_batch`` device_puts P(dp_axes, None...)) and hands every rank
    the contiguous block of rows at its index on the dp axes."""
    jmesh = jsh.make_abstract_mesh(shape, axes)
    dp_axes = tuple(a for a in ("pod", "data") if a in axes)
    monkeypatch.setattr(jpipeline.jax, "device_put", lambda v, s: s.spec)
    batch = {"tokens": np.arange(8 * 3).reshape(8, 3),
             "labels": np.arange(8 * 3).reshape(8, 3) + 100}
    want = jpipeline.shard_batch(batch, jmesh, dp_axes)
    dist = sh.make_dist(AbstractMesh(shape, axes))
    specs = sh.make_batch_shardings(
        {k: torch.from_numpy(v) for k, v in batch.items()}, dist)
    assert {k: _norm(v) for k, v in want.items()} == specs
    n = int(np.prod([dict(zip(axes, shape))[a] for a in dp_axes]))
    seen = []
    for rank in range(int(np.prod(shape))):
        mesh = RankMesh(shape, axes, rank, {}, None, "gloo")
        rows = shard_batch(batch, dataclasses.replace(dist, mesh=mesh))
        i = mesh.index(dist.dp_axes)
        np.testing.assert_array_equal(rows["tokens"],
                                      batch["tokens"][i * 8 // n:
                                                      (i + 1) * 8 // n])
        seen.append(i)
    assert sorted(set(seen)) == list(range(n))
    if n > 1:
        with pytest.raises(NotImplementedError, match="not yet ported"):
            shard_batch({"tokens": np.zeros((n + 1, 2))},
                        dataclasses.replace(dist, mesh=mesh))


@pytest.mark.parametrize("shape,axes", MESH_SPECS[:3] + MESH_SPECS[4:],
                         ids=["2x2", "1x2", "2x1", "2x2x2"])
def test_shard_batch_gives_each_microbatch_its_dp_block(shape, axes):
    """With 2 microbatches a rank's rows are, microbatch by microbatch,
    its dp block of the reference step's split of the global batch
    (``x.reshape(M, B // M, ...)``, each microbatch sharded over dp), so
    the step's reshape hands each microbatch the reference's rows; over
    the ranks every row comes once per model index. Rows that M
    microbatches over dp do not divide are refused."""
    dist = sh.make_dist(AbstractMesh(shape, axes))
    n_dp = int(np.prod([dict(zip(axes, shape))[a] for a in dist.dp_axes]))
    batch = {"tokens": np.arange(8 * 3).reshape(8, 3)}
    split = batch["tokens"].reshape(2, 4, 3)
    n = 4 // n_dp
    seen = []
    for rank in range(int(np.prod(shape))):
        mesh = RankMesh(shape, axes, rank, {}, None, "gloo")
        d = dataclasses.replace(dist, mesh=mesh)
        rows = shard_batch(batch, d, microbatches=2)["tokens"]
        i = mesh.index(dist.dp_axes)
        got = rows.reshape(2, rows.shape[0] // 2, 3)
        for m in range(2):
            np.testing.assert_array_equal(got[m],
                                          split[m, i * n:(i + 1) * n])
        if mesh.coords["model"] == 0:
            seen.extend(rows[:, 0].tolist())
    assert sorted(seen) == batch["tokens"][:, 0].tolist()
    with pytest.raises(NotImplementedError, match="not yet ported"):
        shard_batch({"tokens": np.zeros((2 * n_dp + n_dp, 2))}, d,
                    microbatches=2)


@pytest.mark.parametrize("where", ["1x2", "2x1", "one device"])
def test_checkpoint_of_2x2_restores_bit_for_bit(runs, where):
    """The (params, Adam state) that a (2, 2) run saved at step 2 restore
    on (1, 2), (2, 1) and one device as the same logical arrays, bit for
    bit, each rank holding its slice's shape."""
    saved = runs["w4"][0][2]["saved"]
    if where == "one device":
        got = runs["ckpt"]["one_device"]
        assert runs["ckpt"]["meta_step"] == 2
    else:
        shape = tuple(int(x) for x in where.split("x"))
        got, step, shapes = runs["w2"][0][1][shape]
        assert step == 2
        assert shapes != [a.shape for a in saved]   # the rank's slices
        assert all(np.array_equal(a, b) for a, b in zip(
            runs["w2"][1][1][shape][0], got))
    assert len(got) == len(saved)
    assert all(a.dtype == b.dtype and np.array_equal(a, b)
               for a, b in zip(got, saved))


def test_resume_is_bit_equal_to_straight_steps(runs):
    """On (2, 2): 2 steps, a checkpoint, a resumed run to 4: every rank's
    final params equal 4 straight steps' bit for bit; the resumed run
    says where it started."""
    for r in runs["w4"]:
        c = r[2]
        assert all(np.array_equal(a, b)
                   for a, b in zip(c["resumed"], c["straight"]))
    lines = runs["w4"][0][2]["lines"]
    assert lines["resumed"][0] == "[train] resumed from step 2"
    assert [ln.split(" loss")[0] for ln in lines["straight"]] == \
        [f"[train] step {i}" for i in (1, 2, 3, 4)]
    assert runs["ckpt"]["steps"] == [2, 4]


def test_sigterm_to_one_rank_checkpoints_every_rank(runs):
    """Rank 1 sends itself SIGTERM after its second step of five: every
    rank stops at step 2 after one collective checkpoint (no deadlock:
    the spawn returned), and each says so."""
    for r in runs["w4"]:
        assert r[2]["sigterm_step"] == 2
        assert "[train] preempted at step 2; checkpointing" in \
            r[2]["lines"]["sigterm"]
    assert runs["ckpt"]["sigterm_steps"] == [2]


def test_launcher_trains_on_a_mesh(monkeypatch, capsys):
    """``train.main(["--mesh", "1x2", ...])`` with ``get_config`` patched
    to the reduced config: 2 ranks (the config resolved before the spawn
    reaches them), the loop's lines from rank 0, finite losses equal on
    both ranks, half of the params on each."""
    orig = train.get_config
    monkeypatch.setattr(train, "get_config", lambda a: orig(a).reduced())
    lines, report = [], []
    out = train.main(["--arch", "gemma2-2b", "--mesh", "1x2", "--steps",
                      "2", "--batch", "4", "--seq", "16", "--lr", "1e-3"],
                     device=CPU, log_every=1, log=lines.append,
                     report=report)
    assert lines[0] == "[train] 2 batches of 4 x 16 drawn for the ranks " \
        "in " + lines[0].split(" in ")[1]
    assert [ln.split(" loss")[0] for ln in lines[1:]] == \
        ["[train] step 1", "[train] step 2"]
    assert "[train] finished at step 2; 0 straggler events (2 ranks, mesh " \
        "1x2)" in capsys.readouterr().out
    assert out["step"] == 2 and len(report) == 2
    assert [h["loss"] for h in report[0]["history"]] == \
        [h["loss"] for h in report[1]["history"]]
    assert all(np.isfinite(h["loss"]) for h in report[0]["history"])
    for r in report:
        assert r["param_bytes"] < r["whole_param_bytes"]
        assert r["collective_bytes"]["all_reduce"] > 0


def test_launcher_reduced_takes_no_mesh(capsys):
    """``--reduced --mesh`` trains the reduced config on one device (the
    reference's launcher takes no mesh with --reduced)."""
    out = train.main(["--arch", "gemma2-2b", "--reduced", "--mesh", "1x2",
                      "--steps", "2"], device=CPU)
    assert out["step"] == 2 and "params" in out
    assert capsys.readouterr().out == \
        "[train] finished at step 2; 0 straggler events\n"


def test_drawn_batches_are_the_sources():
    """``DrawnBatches`` hands out the source's batches at the indices it
    drew, and refuses any other."""
    src = SyntheticLM(LMTaskConfig(vocab_size=128, seq_len=8), seed=3)
    drawn = DrawnBatches(src, 4, range(1, 3))
    assert (drawn.cfg, drawn.seed) == (src.cfg, src.seed)
    for i in (1, 2):
        for k, v in src.batch(4, i).items():
            np.testing.assert_array_equal(drawn.batch(4, i)[k], v)
    for args in ((4, 0), (2, 1)):
        with pytest.raises(KeyError, match="was not drawn"):
            drawn.batch(*args)


def test_check_tp_in_training_and_serving():
    """A data axis trains (``training=True``) and stays refused in serving
    under its own message; training refuses KV heads the model axis does
    not divide and MoE routed over the whole batch; ``make_train_step``
    builds QAT under a mesh (``ctx_factory``), its grids refitted on the
    weights that ``weight_cut_dims`` lists cut over ``model``."""
    cfg = get_config("gemma2-2b").reduced()
    d22 = sh.make_dist(AbstractMesh((2, 2), ("data", "model")))
    tfm.check_tp(cfg, d22, training=True)
    with pytest.raises(NotImplementedError,
                       match="a data axis over more than one rank in "
                             "serving"):
        tfm.check_tp(cfg, d22)
    granite = get_config("granite-20b").reduced()
    with pytest.raises(NotImplementedError,
                       match="KV heads on 2 ranks in training"):
        tfm.check_tp(granite, d22, training=True)
    tfm.check_tp(granite, sh.make_dist(AbstractMesh((1, 2), ("data",
                                                             "model"))))
    qwen = get_config("qwen3-moe-235b").reduced()
    with pytest.raises(NotImplementedError, match="routed over the whole"):
        tfm.check_tp(qwen, sh.make_dist(AbstractMesh((2, 1), ("data",
                                                              "model"))),
                     training=True)
    tfm.check_tp(qwen, d22, training=True)
    from repro_torch.runtime import make_train_step
    step = make_train_step(cfg, lr_schedule=1e-3, dist=d22,
                           ctx_factory=lambda: None)
    assert callable(step) and callable(step.loss_and_grads)
    # the weights QAT refits on the whole: the model axis's dim of each
    assert sh.weight_cut_dims(cfg, d22) == {
        "layer/attn/wq": 1, "layer/attn/wk": 1, "layer/attn/wv": 1,
        "layer/attn/wo": 0, "layer/ffn/w_gate": 1, "layer/ffn/w_up": 1,
        "layer/ffn/w_out": 0, "head/w": 1}


def test_qadam_shardings_pad_a_trimmed_spec():
    """A param spec whose trailing dims are replicated is trimmed; the
    scales drop the last dim's entry, not the last entry left (the
    reference's rule takes the latter: a sharded dim's)."""
    mesh = AbstractMesh((2, 2), ("data", "model"))
    for_leaf = qadam_shardings(None)
    leaf = for_leaf(sh.NamedSharding(mesh, ("model",)), 2)
    assert leaf["s"].spec == ("model",) and leaf["q"].spec == ("model",)
    assert for_leaf(sh.NamedSharding(mesh, ("model", "data")))["s"].spec \
        == ("model",)
