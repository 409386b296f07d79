"""Tensor-parallel serving in the port (``repro_torch.parallel``,
``launch/mesh.py``, ``DistContext``, ``make_engine(dist=)``, ``serve
--tp``) against the reference, on the CPU.

* Spec parity: the port's ``make_param_specs`` on every arch's reduced
  param tree (stacked and unrolled) and on gemma2-2b's packed deploy tree,
  ``param_spec_for`` on every arch's full-size leaves, and
  ``make_cache_specs`` / ``cache_spec_for`` on every cache type (with
  ``kv_seq_shard`` on and off), over the meshes (1, 2), (1, 4), (16, 16)
  and (2, 16, 16), equal the reference's specs (its ``make_abstract_mesh``
  meshes); the reference's ``TestShardingRules`` cases on the port.
* The reference's sharded engine scenario (``tests/test_engine.py``) on a
  2-rank gloo group (one spawn for every case), the caches on their KV
  heads (``kv_seq_shard=False``; ``tests/test_torch_kvseq.py`` runs the
  same modes in the default layout): reduced gemma2-2b on the
  reference's params and calibration carried across, f32 and deploy-int8
  greedy tokens equal on both ranks, to the port's unsharded engine and to
  the reference's unsharded ``make_engine`` + ``serve_engine``; the first
  decode step's logits within 1e-5 of max|logits|; the host arrays the
  engine puts equal on both ranks; each rank's bytes of the
  ``model``-placed leaves summing to the whole; the collectives.
* The launcher: ``--tp 2`` (the default layout, caches on the sequence
  dim) on the README quickstart with ``--parity``, and ``--async
  --parity``: the unsharded runs' tokens and lines.
* Every refusal, with its message; the serving flags once refused
  (``--prefix-cache``, ``--over-commit``, ``--swap-blocks``, ``--trace``,
  ``--metrics-every``, ``--quant-telemetry``) served on 2 ranks.
"""
import contextlib
import dataclasses
import functools
import io
import tempfile
import threading
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jget_config
from repro.core import Mode as JMode
from repro.core import QuantCtx as JQuantCtx
from repro.core import build_deploy as jbuild_deploy
from repro.core import peg_policy as jpeg_policy
from repro.core.pipeline import ptq as jptq
from repro.models import transformer as jtfm
from repro.parallel import sharding as jsh
from repro.runtime import Request as JRequest
from repro.runtime import serve_engine as jserve_engine
from repro.runtime.engine import make_engine as jmake_engine
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import act_state_from_jax, params_from_jax
from repro_torch.core import Mode, QuantCtx, build_deploy, peg_policy
from repro_torch.launch import serve
from repro_torch.launch.mesh import (AbstractMesh, make_mesh_from_spec,
                                     make_production_mesh, run_ranks)
from repro_torch.models import transformer as tfm
from repro_torch.parallel import sharding as sh
from repro_torch.runtime import Request, make_engine, serve_engine

import torch_tp_ranks as ranks

pytestmark = [pytest.mark.serve]

CPU = "cpu"
MESHES = [((1, 2), ("data", "model")), ((1, 4), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
MESH_IDS = ["1x2", "1x4", "16x16", "2x16x16"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the module (and for each spawned rank)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _dists(shape, axes, kv_seq_shard=True):
    """(the reference's DistContext-like, the port's DistContext) over
    abstract meshes; the reference reads ``kv_seq_shard`` by getattr."""
    jd = jsh.make_dist(jsh.make_abstract_mesh(shape, axes))
    if not kv_seq_shard:
        jd = types.SimpleNamespace(**{f.name: getattr(jd, f.name)
                                      for f in dataclasses.fields(jd)},
                                   kv_seq_shard=False)
    d = dataclasses.replace(sh.make_dist(sh.make_abstract_mesh(shape, axes)),
                            kv_seq_shard=kv_seq_shard)
    return jd, d


def _jspecs(specs):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))
    return {jsh._leaf_path(path): tuple(s) for path, s in flat}


def _port_specs(tree, specs, prefix=()):
    """{path: spec} of a port spec tree laid over the tree it describes."""
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_port_specs(tree[k], specs[k], prefix + (str(k),)))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for k, a, b in zip(tree._fields, tree, specs):
            out.update(_port_specs(a, b, prefix + (f".{k}",)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, (a, b) in enumerate(zip(tree, specs)):
            out.update(_port_specs(a, b, prefix + (str(i),)))
        return out
    return {"/".join(prefix): specs}


@functools.lru_cache(maxsize=None)
def _jparam_shapes(arch, stacked, full=False):
    cfg = jget_config(arch)
    cfg = cfg if full else cfg.reduced()
    return jax.eval_shape(lambda: jtfm.init_params(
        cfg, jax.random.PRNGKey(0), stacked=stacked, dtype=jnp.float32))


@functools.lru_cache(maxsize=None)
def _port_params(arch, stacked):
    return tfm.init_params(get_config(arch).reduced(), 0, stacked=stacked,
                           dtype=torch.float32, device=CPU)


# ---------------------------------------------------------------------------
# (a) spec parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "flat"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, stacked, mesh):
    jd, d = _dists(*mesh)
    params = _port_params(arch, stacked)
    want = _jspecs(jsh.make_param_specs(_jparam_shapes(arch, stacked), jd))
    got = _port_specs(params, sh.make_param_specs(params, d))
    assert got == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_size_param_rules_match_reference(arch):
    """``param_spec_for`` on every leaf of the full-size stacked tree
    (shapes only): the large-leaf default and the MoE fallback too."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        _jparam_shapes(arch, True, full=True))
    for mesh in MESHES:
        jd, d = _dists(*mesh)
        for path, leaf in flat:
            p = jsh._leaf_path(path)
            want = tuple(jsh.param_spec_for(p, leaf.shape, jd,
                                            has_scan_dim="scan" in p))
            assert sh.param_spec_for(p, tuple(leaf.shape), d,
                                     has_scan_dim="scan" in p) == want, p


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_packed_deploy_specs_match_reference(models, mesh):
    """gemma2-2b's packed deploy tree: the same specs, and no packed
    payload leaf on ``model`` (no TP rule matches their field paths, so
    the integer kernels run on whole weights on every rank)."""
    jd, d = _dists(*mesh)
    want = _jspecs(jsh.make_param_specs(models["jpacked"], jd))
    packed = models["packed"]
    got = _port_specs(packed, sh.make_param_specs(packed, d))
    assert got == want
    payload = [p for p in got if p.rsplit("/", 1)[-1] in ("q", "q4", "s",
                                                          "colsum")]
    assert len(payload) >= 28
    for p in payload:
        assert "model" not in got[p], p


CACHE_KINDS = [(16, False), (8, False), (4, False), (16, True), (8, True),
               (4, True)]


def _cache_pair(arch, kv_bits, paged, stacked):
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    kw = dict(stacked=stacked, dtype=jnp.float32, kv_bits=kv_bits)
    if paged:
        kw.update(paged=True, block_size=4)
    jcache = jax.eval_shape(lambda: jtfm.init_cache(jcfg, 4, 32, **kw))
    kw["dtype"] = torch.float32
    return jcache, tfm.init_cache(cfg, 4, 32, device=CPU, **kw)


def _jcache_specs(jcache, jd):
    flat, _ = jax.tree_util.tree_flatten_with_path(jcache)
    out = {}
    for path, leaf in flat:
        p = jsh._leaf_path(path)
        scan = "scan" in p or "self_kv" in p or "cross" in p
        out[p] = tuple(jsh.cache_spec_for(leaf.shape, jd, has_scan_dim=scan))
    return out


@pytest.mark.parametrize("kv_seq_shard", [True, False],
                         ids=["kvseq", "kvhead"])
@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "flat"])
@pytest.mark.parametrize("kv_bits,paged", CACHE_KINDS,
                         ids=[f"kv{b}{'-paged' if p else ''}"
                              for b, p in CACHE_KINDS])
def test_cache_specs_match_reference(kv_bits, paged, stacked, kv_seq_shard):
    jcache, cache = _cache_pair("gemma2-2b", kv_bits, paged, stacked)
    for mesh in MESHES:
        jd, d = _dists(*mesh, kv_seq_shard=kv_seq_shard)
        got = _port_specs(cache, sh.make_cache_specs(cache, d))
        assert got == _jcache_specs(jcache, jd), mesh


@pytest.mark.parametrize("kv_seq_shard", [True, False],
                         ids=["kvseq", "kvhead"])
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-1p6b"])
def test_state_cache_specs_match_reference(arch, kv_seq_shard):
    """The recurrent states (and recurrentgemma's window caches)."""
    jcache, cache = _cache_pair(arch, 8, False, True)
    for mesh in MESHES:
        jd, d = _dists(*mesh, kv_seq_shard=kv_seq_shard)
        got = _port_specs(cache, sh.make_cache_specs(cache, d))
        assert got == _jcache_specs(jcache, jd), mesh


@pytest.mark.parametrize("kv_bits,paged", CACHE_KINDS,
                         ids=[f"kv{b}{'-paged' if p else ''}"
                              for b, p in CACHE_KINDS])
def test_kv_head_placement_is_the_kvhead_rule_on_payloads(kv_bits, paged):
    """The placement the port executes: payloads on their KV-head dim, as
    ``cache_spec_for(kv_seq_shard=False)`` puts them on ``model``; their
    per-(token, head) scales on the same head dim; positions and the block
    table whole."""
    _, cache = _cache_pair("gemma2-2b", kv_bits, paged, True)
    _, d = _dists((1, 2), ("data", "model"), kv_seq_shard=False)
    ref = _port_specs(cache, sh.make_cache_specs(cache, d))
    got = _port_specs(cache, sh.make_kv_head_specs(cache, d))
    for path, spec in got.items():
        field = path.rsplit("/", 1)[-1]
        if field in (".pos", "block_table"):
            assert spec == (), path
        elif field in (".k", ".v", ".k_q", ".v_q"):
            assert spec.index("model") == ref[path].index("model") \
                == len(spec) - 1 == 3, path
        else:
            assert field in (".k_s", ".v_s") and spec.index("model") == 3


class TestShardingRules:
    """``tests/test_distribution.py``'s rule cases, on the port."""

    def test_attention_projections(self):
        _, d = _dists((16, 16), ("data", "model"))
        assert sh.param_spec_for("scan/0/attn/wq", (24, 3840, 3840), d,
                                 has_scan_dim=True) == (None, "data", "model")
        assert sh.param_spec_for("scan/0/attn/wo", (24, 3840, 3840), d,
                                 has_scan_dim=True) == (None, "model", "data")

    def test_mqa_kv_falls_back_to_head_dim(self):
        _, d = _dists((16, 16), ("data", "model"))
        assert sh.param_spec_for("scan/0/attn/wk", (52, 6144, 128), d,
                                 has_scan_dim=True) == (None, "data", "model")

    def test_indivisible_dim_replicates(self):
        _, d = _dists((16, 16), ("data", "model"))
        assert sh.param_spec_for("scan/0/attn/wq", (26, 2305, 2048), d,
                                 has_scan_dim=True) == (None, None, "model")

    def test_moe_experts_ep_on_model(self):
        _, d = _dists((16, 16), ("data", "model"))
        assert sh.param_spec_for("scan/0/moe/w_gate", (94, 128, 4096, 1536),
                                 d, has_scan_dim=True) == (None, "model",
                                                           "data")
        assert sh.param_spec_for("scan/0/moe/w_out", (94, 128, 1536, 4096),
                                 d, has_scan_dim=True) == (None, "model",
                                                           None, "data")

    def test_embed_vocab_tp(self):
        _, d = _dists((16, 16), ("data", "model"))
        assert sh.param_spec_for("embed", (256000, 2304), d,
                                 has_scan_dim=False) == ("model", "data")

    def test_multipod_fsdp_spans_pod(self):
        _, d = _dists((2, 16, 16), ("pod", "data", "model"))
        assert sh.param_spec_for("scan/0/attn/wq", (94, 4096, 8192), d,
                                 has_scan_dim=True) == (
            None, ("pod", "data"), "model")

    def test_norms_replicated(self):
        _, d = _dists((16, 16), ("data", "model"))
        assert sh.param_spec_for("scan/0/ln1/g", (24, 3840), d,
                                 has_scan_dim=True) == ()

    def test_kv_cache_batch_and_sequence(self):
        _, d = _dists((16, 16), ("data", "model"))
        assert sh.cache_spec_for((48, 128, 32768, 8, 128), d,
                                 has_scan_dim=True) == (None, "data",
                                                        "model")

    def test_batch1_long_context_sp(self):
        _, d = _dists((16, 16), ("data", "model"))
        spec = sh.cache_spec_for((13, 1, 524288, 4, 256), d,
                                 has_scan_dim=True)
        assert spec[1] is None and spec[2] == "data"

    def test_rwkv_state(self):
        _, d = _dists((16, 16), ("data", "model"))
        spec = sh.cache_spec_for((24, 128, 32, 64, 64), d, has_scan_dim=True)
        assert spec[1] == "data"

    def test_meshes(self):
        assert make_production_mesh().shape == {"data": 16, "model": 16}
        assert make_production_mesh(multi_pod=True).shape == {
            "pod": 2, "data": 16, "model": 16}
        assert make_mesh_from_spec("8x16").axis_names == ("data", "model")
        assert make_mesh_from_spec("2x8x16").size == 256
        with pytest.raises(ValueError, match="bad mesh spec"):
            make_mesh_from_spec("8")
        d = sh.make_dist(make_mesh_from_spec("2x8x16"))
        assert (d.fsdp_axis, d.dp_axes, d.tp_size) == (
            ("pod", "data"), ("pod", "data"), 16)
        assert sh.batch_spec(d) == (("pod", "data"),)
        serving = sh.serving_dist(AbstractMesh((1, 2), ("data", "model")))
        assert serving.kv_seq_shard is True
        assert serving == sh.make_dist(serving.mesh)


# ---------------------------------------------------------------------------
# (b) the engine on a 2-rank gloo group
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """Reduced gemma2-2b on the reference's params with the reference
    test's calibration (PEG, ``PRNGKey(10)``); one spawn of 2 CPU ranks
    running every engine scenario (``torch_tp_ranks.engine_scenarios``),
    while this process packs the deploy params in both packages and runs
    the reference's unsharded ``make_engine`` + ``serve_engine`` (f32 and
    deploy, dense kv16, as its sharded test)."""
    jcfg = jget_config("gemma2-2b").reduced()
    cfg = get_config("gemma2-2b").reduced()
    key = jax.random.PRNGKey(0)
    jstacked = jtfm.init_params(jcfg, key, stacked=True, dtype=jnp.float32)
    jflat = jtfm.init_params(jcfg, key, stacked=False, dtype=jnp.float32)
    calib = [{"tokens": jax.random.randint(jax.random.PRNGKey(10), (2, 8),
                                           0, jcfg.vocab_size)}]
    jqm = jptq(lambda p, b, c: jtfm.forward(jcfg, p, b["tokens"], ctx=c)[0],
               jflat, calib, jpeg_policy(4), collect_inputs=True)
    jshared = {}
    for site, qp in jqm.act_state.items():
        base = ("layer/" + site.split("/", 1)[1]
                if site.startswith("layer") else site)
        jshared.setdefault(base, qp)
    got = []
    spawn = threading.Thread(target=lambda: got.append(run_ranks(
        ranks.engine_scenarios, 2, (_np_tree(jstacked), _np_tree(jshared)),
        device=CPU, threads=1)))
    spawn.start()
    try:
        jpacked, jacts = jbuild_deploy(jcfg, jstacked, jpeg_policy(4),
                                       jshared)
        stacked = params_from_jax(_np_tree(jstacked), CPU)
        shared = act_state_from_jax(_np_tree(jshared), CPU)
        packed, acts = build_deploy(cfg, stacked, peg_policy(4), shared)

        def jctx():
            return JQuantCtx(policy=jpeg_policy(4), mode=JMode.DEPLOY,
                             act_state=jshared, deploy_acts=jacts)

        def ctx():
            return QuantCtx(policy=peg_policy(4), mode=Mode.DEPLOY,
                            act_state=shared, deploy_acts=acts)
        ref, port = {}, {}
        for tag, jparams, jc, params, c in (
                ("f32", jstacked, None, stacked, None),
                ("deploy", jpacked, jctx, packed, ctx)):
            eng = jmake_engine(jcfg, jparams, batch_slots=2,
                               prompt_pad_len=ranks.PAD,
                               max_len=ranks.MAX_LEN, dtype=jnp.float32,
                               ctx_factory=jc)
            reqs = ranks.mk_reqs(JRequest, jcfg.vocab_size)
            jserve_engine(eng, reqs)
            ref[tag] = [r.tokens_out for r in reqs]
            eng = make_engine(cfg, params, batch_slots=2,
                              prompt_pad_len=ranks.PAD, max_len=ranks.MAX_LEN,
                              dtype=torch.float32, ctx_factory=c, device=CPU)
            reqs = ranks.mk_reqs(Request, cfg.vocab_size)
            serve_engine(eng, reqs)
            port[tag] = [r.tokens_out for r in reqs]
    finally:
        spawn.join(timeout=600)
    assert not spawn.is_alive() and got, "the ranks did not report"
    return dict(ranks=got[0], ref=ref, port=port, jpacked=jpacked,
                packed=packed)


MODES = ["f32", "f32_onehot", "apply", "deploy", "deploy_kv8",
         "deploy_paged_kv8", "armed_apply", "armed_deploy_paged_kv8"]


@pytest.mark.parametrize("mode", MODES)
def test_sharded_engine_tokens(models, mode):
    """Both ranks emit the same greedy tokens as the engine unsharded on
    the same params; f32 and deploy also equal the reference's unsharded
    engine and the port's unsharded engine in this process."""
    r0, r1 = models["ranks"]
    un = {"f32_onehot": "f32_un"}.get(mode, mode + "_un")
    assert r0[mode] == r1[mode] == r0[un] == r1[un]
    if mode in models["ref"]:
        assert r0[mode] == models["ref"][mode] == models["port"][mode]


def test_first_decode_logits_within_bound(models):
    """f32: the sharded first decode step's logits within 1e-5 of
    max|logits| of the unsharded ones (the row-parallel sums reassociate),
    the same bytes on both ranks (the head's slices are gathered)."""
    r0, r1 = models["ranks"]
    want = r0["logits_un"]
    gap = float((r0["logits"] - want).abs().max() / want.abs().max())
    assert gap <= 1e-5, gap
    assert torch.equal(r0["logits"], r1["logits"])
    assert r0["logits"].shape == want.shape == (2, 1, 128)


def test_put_arrays_equal_on_both_ranks(models):
    """Every host array the sharded engine put (tokens, positions, admit
    masks) is the same on both ranks: the host loop decides alike."""
    r0, r1 = models["ranks"]
    assert len(r0["masks"]) == len(r1["masks"]) > 0
    assert any(m.dtype == np.bool_ for m in r0["masks"])
    for a, b in zip(r0["masks"], r1["masks"]):
        np.testing.assert_array_equal(a, b)


def test_model_placed_bytes_sum_to_the_whole(models):
    """Each rank holds half of every leaf placed on ``model`` (the vocab
    rows of the tied embed, the column and row shards of every projection
    and FFN matrix), so the ranks' bytes sum to the whole."""
    r0, r1 = models["ranks"]
    assert set(r0["model_bytes"]) == set(r1["model_bytes"])
    assert "embed" in r0["model_bytes"]
    assert any(p.endswith("ffn/w_out") for p in r0["model_bytes"])
    assert any(p.endswith("attn/wq") for p in r0["model_bytes"])
    for path, (b0, whole) in r0["model_bytes"].items():
        assert b0 + r1["model_bytes"][path][0] == whole, path
        assert b0 * 2 == whole, path


def test_cache_shardings_keep_each_rank_its_slice(models):
    """``make_cache_shardings`` (the reference's rule, here with the KV-head
    branch of the serving mesh) cuts every leaf in half along each dim its
    spec puts on ``model``, on both ranks."""
    r0, r1 = models["ranks"]
    cache = tfm.init_cache(get_config("gemma2-2b").reduced(), 4,
                           ranks.MAX_LEN, dtype=torch.float32, kv_bits=8,
                           paged=True, block_size=4, device=CPU)
    _, d = _dists((1, 2), ("data", "model"), kv_seq_shard=False)
    specs = _port_specs(cache, sh.make_cache_specs(cache, d))
    whole = dict(sh.tree_leaves_with_path(cache))
    assert r0["cache_placed"] == r1["cache_placed"]
    assert set(r0["cache_placed"]) == set(whole)
    for path, shape in r0["cache_placed"].items():
        want = [n // 2 if i < len(specs[path]) and specs[path][i] == "model"
                else n for i, n in enumerate(whole[path].shape)]
        assert list(shape) == want, path


def test_collectives(models):
    r0, r1 = models["ranks"]
    c0, c1 = r0["collectives"], r1["collectives"]
    for key in ("gather_i8", "gather_bf16", "gather_f32", "sum_bf16",
                "sum_f32", "broadcast"):
        assert torch.equal(c0[key], c1[key]), key
    assert c0["gather_i8"].tolist() == [[-100] * 3 + [-99] * 3] * 2
    assert c0["gather_i8"].dtype == torch.int8
    assert c0["gather_bf16"].dtype == torch.bfloat16
    assert c0["gather_bf16"][2:].eq(1.0 + 1 / 256).all()
    f32 = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    assert torch.equal(c0["gather_f32"], torch.cat([f32, f32 + 10], dim=1))
    assert torch.equal(c0["sum_f32"], 2 * f32 + 10)
    want = (torch.full((4,), 2.0 + 2.0 ** -7)).to(torch.bfloat16)
    assert c0["sum_bf16"].dtype == torch.bfloat16
    assert torch.equal(c0["sum_bf16"], want)
    assert torch.equal(c0["broadcast"], f32 + 10)
    assert c0["agree"] == c1["agree"] == [1, 0, 7]
    assert c0["identity"] and c1["identity"]
    assert r0["collective_s"] > 0


# ---------------------------------------------------------------------------
# (c) the launcher
# ---------------------------------------------------------------------------

QUICK = ("--arch gemma2-2b --reduced --requests 6 --prompt-len 24 "
         "--new-tokens 6 --max-len 64 --quantize --deploy-int8 --kv-bits 8 "
         "--scheduler continuous --paged-kv --block-size 8 --prefill-chunk 8 "
         "--parity").split()
ASYNC = ("--arch gemma2-2b --reduced --quantize --deploy-int8 --kv-bits 8 "
         "--async --parity").split()


@pytest.mark.parametrize("argv", [QUICK, ASYNC], ids=["quickstart", "async"])
def test_launcher_tp2_matches_unsharded(argv, capsys):
    """``--tp 2`` serves the unsharded run's greedy tokens and prints its
    lines (rank 0's output; the serve line's counts, the startup checks
    and every ``[parity] OK``), plus the ``tp=`` note on ``--async``."""
    un, tp = [], []
    serve.main(argv, device=CPU, report=un)
    out_un = capsys.readouterr().out
    serve.main(argv + ["--tp", "2"], device=CPU, report=tp)
    out_tp = capsys.readouterr().out
    assert len(tp) == 2 and tp[0]["tokens"] == un[0]["tokens"]
    assert tp[1]["tokens"] == un[0]["tokens"]
    assert [r["device"] for r in tp] == ["cpu", "cpu"]
    assert tp[0]["param_bytes"] < tp[0]["whole_param_bytes"]
    lines_un, lines_tp = out_un.splitlines(), out_tp.splitlines()
    assert len(lines_un) == len(lines_tp)
    for a, b in zip(lines_un, lines_tp):
        if a.startswith("[serve:"):
            head = a.split(", ")[:3] if "async" not in a else a.split(" ")[:6]
            assert b.startswith(", ".join(head) if "async" not in a
                                else " ".join(head)), (a, b)
        else:
            assert a == b
    assert out_tp.count("[parity] OK") == (3 if argv is QUICK else 2)
    if argv is ASYNC:
        assert ", tp=2 over 2 ranks" in out_tp


# ---------------------------------------------------------------------------
# (d) refusals
# ---------------------------------------------------------------------------

REFUSED = [
    (["--arch", "recurrentgemma-2b"], "recurrent blocks"),
    (["--arch", "seamless-m4t-medium"], "encoder-decoder"),
    (["--arch", "gemma2-2b", "--scheduler", "continuous", "--paged-kv",
      "--block-size", "3"], "3 cells on 2 ranks"),
    (["--arch", "gemma2-2b", "--scheduler", "continuous", "--paged-kv",
      "--prefix-cache"], "--prefix-cache"),
    (["--arch", "gemma2-2b", "--scheduler", "continuous", "--paged-kv",
      "--over-commit"], "--over-commit"),
    (["--arch", "gemma2-2b", "--scheduler", "continuous", "--paged-kv",
      "--over-commit", "--swap-blocks"], "--over-commit"),
    (["--arch", "gemma2-2b", "--scheduler", "continuous", "--trace",
      "t.json"], "--trace"),
    (["--arch", "gemma2-2b", "--scheduler", "continuous",
      "--metrics-every", "2"], "--metrics-every"),
    (["--arch", "gemma2-2b", "--scheduler", "continuous", "--quantize",
      "--quant-telemetry"], "--quant-telemetry"),
]


# the cases above that --tp serves now, each on a small workload
SERVED = ("--prefix-cache", "--over-commit", "--trace", "--metrics-every",
          "--quant-telemetry")
SMALL = ["--reduced", "--requests", "4", "--prompt-len", "8",
         "--new-tokens", "4", "--max-len", "32", "--block-size", "4",
         "--batch-slots", "2"]


def _served_argv(extra, where):
    return [str(Path(where) / a) if a.endswith(".json") else a
            for a in extra] + SMALL


@pytest.fixture(scope="module")
def served_flags():
    """The ``REFUSED`` cases that ``--tp 2`` serves, through the
    launcher's serve body on 2 CPU ranks in one spawn
    (``torch_tp_ranks.serve_runs``), and unsharded in this process:
    {case index: (rank 0's report and output, rank 1's report, the
    unsharded report and output)}."""
    cases = {i: extra for i, (extra, what) in enumerate(REFUSED)
             if what in SERVED}
    with tempfile.TemporaryDirectory() as tmp:
        got = run_ranks(ranks.serve_runs, 2, ({i: _served_argv(e, tmp)
                                              for i, e in cases.items()},),
                        device=CPU, threads=1)
        out = {}
        for i, extra in cases.items():
            report, buf = [], io.StringIO()
            with contextlib.redirect_stdout(buf):
                serve.main(_served_argv(extra, tmp), device=CPU,
                           report=report)
            out[i] = (got[0][i][:2], got[1][i][1], (report[0],
                                                    buf.getvalue()))
    return out


@pytest.mark.parametrize("extra,what", REFUSED,
                         ids=[w.split()[0].strip("-") + str(i)
                              for i, (_, w) in enumerate(REFUSED)])
def test_launcher_refuses_before_building(extra, what, capsys, request):
    """``--tp 2`` refuses, before it builds anything, what the sharded
    forward cannot serve (recurrent blocks, the encoder-decoder, cells
    the ranks do not divide). The serving flags it refused before this
    port served them (``SERVED``) are accepted: both ranks serve the
    unsharded run's greedy tokens and rank 0 prints the flag's lines."""
    if what in SERVED:
        i = next(j for j, case in enumerate(REFUSED) if case[0] is extra)
        (text, r0), r1, (un, un_text) = \
            request.getfixturevalue("served_flags")[i]
        assert r0["tokens"] == r1["tokens"] == un["tokens"]
        assert len(un["tokens"]) == 4
        mark = {"--prefix-cache": "prefix-cache hits",
                "--over-commit": "over-commit: ", "--trace": "[trace] ",
                "--metrics-every": "serve_tokens_generated ",
                "--quant-telemetry": "[quant-health] "}[what]
        assert mark in text and mark in un_text
        return
    with pytest.raises(SystemExit):
        serve.main(extra + ["--reduced", "--tp", "2"], device=CPU)
    err = capsys.readouterr().err
    assert what in err and "is not yet ported under --tp / dist" in err


def test_launcher_tp_checks_of_the_reference(capsys):
    """The reference launcher's own ``--tp`` checks: N >= 1, and ``--tp``
    only with ``--reduced`` (its message); ``--multi-pod`` is refused."""
    for argv, msg in (
            (["--tp", "0", "--reduced"], "--tp must be >= 1"),
            (["--tp", "2"], "--tp is the host-simulated tensor-parallel "
                            "mode (--reduced); the full-size path builds "
                            "its own production mesh"),
            (["--multi-pod", "--reduced"], "--multi-pod is not yet ported "
                                          "under --tp / dist")):
        with pytest.raises(SystemExit):
            serve.main(["--arch", "gemma2-2b"] + argv, device=CPU)
        assert msg in capsys.readouterr().err


def test_engine_refuses_what_the_sharded_forward_cannot_run(models):
    """``make_engine(dist=)`` and the sharded forward refuse, before
    placing anything, recurrent and encoder-decoder configs and a
    ``data`` axis over ranks in either cache layout, and KV heads the
    ranks do not divide with the caches on their KV heads
    (``kv_seq_shard=False``); the sequence layout (the default) serves
    granite-20b's one KV head, and both layouts the MoE configs (expert
    parallelism). Quant telemetry is served: ``make_engine(dist=,
    quant_telemetry=True)`` steps on both ranks (APPLY and deploy paged
    kv8, the KV-head layout), and the report its sink folds equals the
    unsharded engine's (counts exact)."""
    mesh = AbstractMesh((1, 2), ("data", "model"))
    seq = sh.make_dist(mesh)
    kvh = dataclasses.replace(seq, kv_seq_shard=False)
    cfg = get_config("gemma2-2b").reduced()
    params = _port_params("gemma2-2b", True)
    kw = dict(batch_slots=2, prompt_pad_len=8, max_len=32, device=CPU)
    for r in models["ranks"]:
        for tag in ("armed_apply", "armed_deploy_paged_kv8"):
            got, want = r[tag + "_report"], r[tag + "_un_report"]
            assert want["steps_observed"] > 0 and want["sites"]
            assert got["steps_observed"] == want["steps_observed"]
            for site, w in want["sites"].items():
                g = got["sites"][site]
                assert (g["clipped"], g["total"]) == (w["clipped"],
                                                      w["total"]), site
                assert g["observed_amax"] == pytest.approx(
                    w["observed_amax"], rel=1e-6, abs=0)
            assert got["kv_scales"] == want["kv_scales"]
    for dist in (seq, kvh):
        for arch, what in (("rwkv6-1p6b", "recurrent"),
                           ("seamless-m4t-medium", "encoder-decoder")):
            with pytest.raises(NotImplementedError,
                               match=f"{what}.*not yet ported under --tp"):
                tfm.check_tp(get_config(arch).reduced(), dist)
        for arch in ("qwen3-moe-235b", "grok1-314b"):
            tfm.check_tp(get_config(arch).reduced(), dist)
        tfm.check_tp(cfg, dist)
        tfm.check_tp(get_config("bert-base").reduced(), dist)
        with pytest.raises(NotImplementedError, match="more than the model"):
            tfm.check_tp(cfg, dataclasses.replace(
                dist, mesh=AbstractMesh((2, 2), ("data", "model"))))
    with pytest.raises(NotImplementedError,
                       match="KV heads.*not yet ported under --tp"):
        tfm.check_tp(get_config("granite-20b").reduced(), kvh)
    tfm.check_tp(get_config("granite-20b").reduced(), seq)
