"""MoE expert parallelism under ``--tp`` in the port
(``models.moe.moe_apply_sharded``, ``transformer._moe_sharded``) against
the reference's sharded MoE and the unsharded port, on the CPU.

* The reference: its ``_moe_sharded`` (``shard_map`` over a (1, 2)
  ``("data", "model")`` mesh of 2 forced host devices, one subprocess for
  every case) on reduced qwen3-moe (4 experts, top 2: expert-parallel, 2 a
  rank), reduced grok-1 (GELU, un-normalized top 2), a 3-expert hybrid
  case (every expert on a d_ff half) and a qwen3 case whose capacity drops
  rows, at 4 decode rows and a 32-row chunk. The port's sharded block on 2
  gloo ranks (one spawn for every port case) within 1e-5 of max|out| of
  it and of the port's unsharded ``moe_apply``; the sharded body's
  dispatch integers equal the unsharded dispatch's bit for bit, and the
  port's ``_dispatch_indices`` over a local expert range [e_lo, e_hi)
  equals the reference's.
* Placement: each rank holds half of every expert leaf (E/2 experts, or a
  d_ff half in hybrid mode), the router whole; ``init_moe_params(
  num_local_experts=)`` shapes.
* The launcher: ``serve --reduced --tp 2`` on the quickstart's flags for
  qwen3-moe-235b and grok1-314b gives, on both ranks, the greedy tokens of
  the unsharded run with every ``*/router_logits`` site passed through
  (the reference's sharded MoE calls its router without the ctx:
  ``chip_smoke.router_sites_passed``), and its lines; a rank holds half of
  the expert bytes.
"""
import os
import subprocess
import sys
import tempfile
import textwrap
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.launch.mesh import AbstractMesh, run_ranks
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.parallel import sharding as sh

import torch_tp_ranks as ranks

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import router_sites_passed  # noqa: E402

pytestmark = [pytest.mark.serve]

CPU = "cpu"
TOL = 1e-5              # of max|out|
QUICK = ("--reduced --requests 6 --prompt-len 24 --new-tokens 6 --max-len 64 "
         "--quantize --deploy-int8 --kv-bits 8 --scheduler continuous "
         "--paged-kv --block-size 8 --prefill-chunk 8 --parity").split()
ASYNC = "--reduced --quantize --deploy-int8 --kv-bits 8 --async --parity" \
    .split()
ARCHS = ("qwen3-moe-235b", "grok1-314b")
# launcher runs: name -> argv (the quickstart for each arch; the async
# front end for qwen3-moe)
LAUNCH = {**{a: ["--arch", a] + QUICK for a in ARCHS},
          "qwen3-moe-235b-async": ["--arch", "qwen3-moe-235b"] + ASYNC}
SHAPES = {"decode": (4, 1), "chunk": (2, 16)}


def _moe_kw(arch, **over):
    m = get_config(arch).reduced().moe
    kw = dict(num_experts=m.num_experts, top_k=m.top_k, d_ff=m.d_ff,
              capacity_factor=m.capacity_factor, activation=m.activation,
              norm_topk=m.norm_topk, min_capacity=m.min_capacity)
    kw.update(over)
    return kw


# name: (MoEConfig fields, expert-parallel on 2 ranks)
CASES = {
    "qwen3": (_moe_kw("qwen3-moe-235b"), True),
    "grok": (_moe_kw("grok1-314b"), True),
    "hybrid3": (_moe_kw("qwen3-moe-235b", num_experts=3), False),
    "qwen3-drops": (_moe_kw("qwen3-moe-235b", capacity_factor=0.5,
                            min_capacity=2), True),
}
D = get_config("qwen3-moe-235b").reduced().d_model
# the reference's sharded cases: each shard_map compiles for ~11 s here
REF_CASES, REF_SHAPE = ("qwen3", "grok", "hybrid3"), "chunk"


def _case_arrays(name, kw, seed):
    """Whole params (the reference's distributions) and x per shape."""
    rng = np.random.RandomState(seed)
    e, f = kw["num_experts"], kw["d_ff"]
    p = {"router": rng.normal(0, D ** -0.5, (D, e)),
         "w_gate": rng.normal(0, D ** -0.5, (e, D, f)),
         "w_up": rng.normal(0, D ** -0.5, (e, D, f)),
         "w_out": rng.normal(0, f ** -0.5, (e, f, D))}
    xs = {tag: rng.normal(0, 1, (b, t, D)) for tag, (b, t) in SHAPES.items()}
    return ({k: v.astype(np.float32) for k, v in p.items()},
            {k: v.astype(np.float32) for k, v in xs.items()})


REF_SCRIPT = textwrap.dedent("""
    import os, sys, types
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax, jax.numpy as jnp
    import numpy as np

    from repro.models import moe as jmoe
    from repro.models import transformer as jtfm
    from repro.parallel import make_dist

    assert len(jax.devices()) == 2, jax.devices()
    dist = make_dist(jax.make_mesh((1, 2), ("data", "model")))
    src = np.load(sys.argv[1], allow_pickle=True)
    got = {}
    for name, kw in src["spec"].item().items():
        cfg = types.SimpleNamespace(moe=jmoe.MoEConfig(**kw))
        p = {k: jnp.asarray(src[name + "/" + k])
             for k in ("router", "w_gate", "w_up", "w_out", "x")}
        x = p.pop("x")
        got[name] = np.asarray(jtfm._moe_sharded(cfg, p, x, dist))
    np.savez(sys.argv[2], **got)
""")


def _start_reference(arrays, tmp):
    """The reference's ``_moe_sharded`` on 2 forced host devices, started
    in a subprocess (the flag must be set before JAX is imported); returns
    a function that waits for it and loads its outputs."""
    src, dst = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
    flat = {"spec": np.array({n: CASES[n][0] for n in REF_CASES},
                             dtype=object)}
    for name in REF_CASES:
        p, xs = arrays[name]
        flat.update({f"{name}/{k}": v for k, v in p.items()})
        flat[f"{name}/x"] = xs[REF_SHAPE]
    np.savez(src, **flat)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(Path(__file__).resolve().parent.parent / "src")]
        + [x for x in env.get("PYTHONPATH", "").split(os.pathsep) if x])
    proc = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, src, dst],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)

    def wait():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-4000:]
        with np.load(dst) as z:
            return {k: z[k] for k in z.files}
    return wait


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the module (and for each spawned rank)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def moe_ep():
    """One spawn of 2 CPU ranks running ``torch_tp_ranks.
    moe_ep_scenarios`` (every block case and both launcher runs), while
    this process runs the reference's sharded MoE in a subprocess and the
    unsharded launcher runs with the router sites passed through."""
    arrays = {name: _case_arrays(name, kw, seed)
              for seed, (name, (kw, _)) in enumerate(CASES.items())}
    blocks = {name: (CASES[name][0], p, xs)
              for name, (p, xs) in arrays.items()}
    launcher = [(name, argv[1], argv + ["--tp", "2"])
                for name, argv in LAUNCH.items()]
    got = []
    spawn = threading.Thread(target=lambda: got.append(run_ranks(
        ranks.moe_ep_scenarios, 2, (blocks, launcher), device=CPU,
        threads=1)))
    spawn.start()
    un = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            wait = _start_reference(arrays, tmp)
            for name, argv in LAUNCH.items():
                report = []
                with router_sites_passed() as dropped:
                    serve.main(argv, device=CPU, report=report)
                un[name] = dict(report[0], dropped=dropped)
            ref = wait()
    finally:
        spawn.join(timeout=600)
    assert not spawn.is_alive() and got, "the ranks did not report"
    return dict(ranks=got[0], ref=ref, arrays=arrays, un=un)


def _unsharded(name, tag, arrays):
    p, xs = arrays[name]
    kw = CASES[name][0]
    x = torch.from_numpy(xs[tag])
    b, t, d = x.shape
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    return moe.moe_apply(pt, x.reshape(b * t, d), moe.MoEConfig(**kw)) \
        .reshape(b, t, d)


def _gap(got, want):
    want = torch.as_tensor(want)
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("name", REF_CASES)
def test_sharded_block_matches_the_references_sharded_moe(moe_ep, name):
    """The 32-row chunk: within 1e-5 of max|out| of the reference's
    ``_moe_sharded`` on 2 devices (expert-parallel for qwen3 and grok,
    hybrid for the 3-expert case)."""
    got = moe_ep["ranks"][0]["blocks"][name, REF_SHAPE]
    ref = moe_ep["ref"][name]
    assert got.shape == ref.shape
    assert _gap(got, ref) <= TOL, _gap(got, ref)


@pytest.mark.parametrize("tag", list(SHAPES))
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_block_matches_the_unsharded(moe_ep, name, tag):
    """Both ranks return the same output, within 1e-5 of max|out| of the
    port's unsharded ``moe_apply``; each rank's second call gives the same
    bits."""
    r0, r1 = moe_ep["ranks"]
    got = r0["blocks"][name, tag]
    assert torch.equal(got, r1["blocks"][name, tag])
    assert r0["again"][name, tag] and r1["again"][name, tag]
    un = _unsharded(name, tag, moe_ep["arrays"])
    assert _gap(got, un) <= TOL, _gap(got, un)


@pytest.mark.parametrize("tag", list(SHAPES))
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_dispatch_equals_the_unsharded(moe_ep, name, tag):
    """The sharded body's dispatch (over the full expert range, before it
    keeps its own experts' rows) equals the unsharded ``moe_apply``'s bit
    for bit on both ranks: the same order, slots, kept rows and tokens."""
    p, xs = moe_ep["arrays"][name]
    mcfg = moe.MoEConfig(**CASES[name][0])
    x = torch.from_numpy(xs[tag]).reshape(-1, D)
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    _, _, top_e = moe.router_probs(pt, x, mcfg)
    want = moe._dispatch_indices(top_e, mcfg.num_experts,
                                 moe._capacity(x.shape[0], mcfg))
    for r in moe_ep["ranks"]:
        for a, b in zip(r["dispatch"][name, tag], want):
            assert torch.equal(a, b)
    if name == "qwen3-drops" and tag == "chunk":
        assert int((~want[2]).sum()) > 0, "the case drops no row"


@pytest.mark.parametrize("rng_", [(0, None), (0, 2), (2, 4), (1, 3)],
                         ids=["whole", "rank0", "rank1", "middle"])
@pytest.mark.parametrize("name", list(CASES))
def test_dispatch_over_a_local_range_equals_the_reference(moe_ep, name,
                                                           rng_):
    """``_dispatch_indices(top_e, E, C, e_lo, e_hi)``: the port's four
    arrays equal the reference's on the same routing (the trash row at
    (e_hi - e_lo) * C, ``keep`` inside the range), top-k equal too."""
    e_lo, e_hi = rng_
    p, xs = moe_ep["arrays"][name]
    kw = CASES[name][0]
    e_hi = min(kw["num_experts"], e_hi or kw["num_experts"])
    x = xs["chunk"].reshape(-1, D)
    cap = moe._capacity(x.shape[0], moe.MoEConfig(**kw))
    _, _, top_e = moe.router_probs({"router": torch.from_numpy(p["router"])},
                                   torch.from_numpy(x), moe.MoEConfig(**kw))
    _, _, jtop_e = jmoe.router_probs({"router": jnp.asarray(p["router"])},
                                     jnp.asarray(x), jmoe.MoEConfig(**kw))
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(jtop_e))
    got = moe._dispatch_indices(top_e, kw["num_experts"], cap, e_lo, e_hi)
    want = jmoe._dispatch_indices(jtop_e, kw["num_experts"], cap, e_lo,
                                  e_hi)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", list(CASES))
def test_rank_holds_half_of_every_expert_leaf(moe_ep, name):
    """Expert-parallel: E/2 experts a rank; hybrid: every expert on a d_ff
    half; either way half of each expert leaf's bytes, the router whole."""
    for r in moe_ep["ranks"]:
        placed, whole = r["expert_bytes"][name]
        assert placed["router"] == whole["router"]
        for k in ("w_gate", "w_up", "w_out"):
            assert 2 * placed[k] == whole[k], k


def test_placement_modes_follow_the_reference_rules():
    """``param_spec_for``: the experts' E dim on ``model`` where 2 divides
    it, else d_ff (the hybrid fallback), the router whole; the stacked
    leaves keep their layer dim whole."""
    dist = sh.make_dist(AbstractMesh((1, 2), ("data", "model")))

    def spec(path, shape):
        return sh.param_spec_for(path, shape, dist,
                                 has_scan_dim="scan" in path)
    assert spec("scan/0/moe/w_gate", (2, 4, 64, 32)) == \
        (None, "model", "data")
    assert spec("scan/0/moe/w_out", (2, 4, 32, 64)) == \
        (None, "model", None, "data")
    assert spec("scan/0/moe/w_up", (2, 3, 64, 32)) == \
        (None, None, "data", "model")
    assert spec("scan/0/moe/w_out", (2, 3, 32, 64)) == \
        (None, None, "model", "data")
    assert spec("scan/0/moe/router", (2, 64, 4)) == (None, "data")


def test_init_moe_params_num_local_experts():
    """``init_moe_params(num_local_experts=)``: that many experts, the
    router over all of them (the reference's shapes)."""
    mcfg = moe.MoEConfig(**CASES["qwen3"][0])
    p = moe.init_moe_params(torch.Generator().manual_seed(0), D, mcfg,
                            num_local_experts=2)
    assert tuple(p["router"].shape) == (D, 4)
    assert tuple(p["w_gate"].shape) == tuple(p["w_up"].shape) == (2, D, 64)
    assert tuple(p["w_out"].shape) == (2, 64, D)
    whole = moe.init_moe_params(torch.Generator().manual_seed(0), D, mcfg)
    assert tuple(whole["w_gate"].shape) == (4, D, 64)


def test_moe_sharded_refuses_unplaced_experts_and_int8_gathers():
    """The rank's experts must be its slice (the whole experts would be
    summed twice), and ``quantized_gathers`` is not yet ported."""
    import dataclasses
    import types
    dist = sh.make_dist(AbstractMesh((1, 2), ("data", "model")))
    mcfg = moe.MoEConfig(**CASES["qwen3"][0])
    p = moe.init_moe_params(torch.Generator().manual_seed(0), D, mcfg)
    x = torch.zeros(1, 4, D)
    cfg = types.SimpleNamespace(moe=mcfg)
    with pytest.raises(ValueError, match="not its slice"):
        tfm._moe_sharded(cfg, p, x, dist)
    with pytest.raises(NotImplementedError, match="quantized_gathers"):
        tfm._moe_sharded(cfg, p, x, dataclasses.replace(
            dist, quantized_gathers=True))


@pytest.mark.parametrize("name", list(LAUNCH))
def test_launcher_tp2_serves_the_router_passed_tokens(moe_ep, name):
    """``serve --reduced --tp 2`` on the quickstart's flags (and, for
    qwen3-moe, ``--async --parity``: ``make_engine(dist=)`` under the SPMD
    ``AsyncServer``): both ranks emit the greedy tokens of the unsharded
    run with every ``*/router_logits`` site passed through (the function
    the reference serves under ``--tp``), rank 0 prints its counts and
    ``[parity] OK`` lines, and a rank holds half of the expert bytes."""
    un = moe_ep["un"][name]
    assert un["dropped"] == ["layer/ffn/router_logits"]
    tp = [r["launcher"][name] for r in moe_ep["ranks"]]
    n = sum(len(t) for t in un["tokens"])
    async_ = "--async" in LAUNCH[name]
    assert n == (64 if async_ else 36)
    for r in tp:
        assert r["tokens"] == un["tokens"]
        placed, whole = r["expert_bytes"]
        assert placed > 0 and 2 * placed == whole
        assert r["param_bytes"] < r["whole_param_bytes"]
    text = tp[0]["text"]
    assert "fake-quant fallback: MoE experts in 2 layers" in text
    if async_:
        assert text.count("[parity] OK") == 2
        assert "64 tokens from 8 streamed requests" in text
        assert ", tp=2 over 2 ranks" in text
    else:
        assert text.count("[parity] OK") == 3
        assert "36 tokens, 10 decode steps, 6 prefills" in text


def test_check_tp_accepts_moe_and_refuses_what_cannot_split():
    """Both MoE configs pass ``check_tp`` on 2 ranks (and grok-1's 8
    experts on 16, the hybrid mode); experts whose count and d_ff the ranks
    both do not divide, and ``quantized_gathers``, are refused."""
    import dataclasses
    for shape in ((1, 2), (1, 16)):
        dist = sh.make_dist(AbstractMesh(shape, ("data", "model")))
        for arch in ARCHS:
            tfm.check_tp(get_config(arch), dist)
        tfm.check_tp(get_config("qwen3-moe-235b").reduced(),
                     sh.make_dist(AbstractMesh((1, 2), ("data", "model"))))
    dist = sh.make_dist(AbstractMesh((1, 3), ("data", "model")))
    cfg = get_config("qwen3-moe-235b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, d_ff=65))
    with pytest.raises(NotImplementedError,
                       match="4 experts of d_ff 65 on 3 ranks"):
        tfm.check_tp(cfg, dist)
    with pytest.raises(NotImplementedError, match="quantized_gathers"):
        tfm.check_tp(get_config("grok1-314b"), dataclasses.replace(
            sh.make_dist(AbstractMesh((1, 2), ("data", "model"))),
            quantized_gathers=True))
