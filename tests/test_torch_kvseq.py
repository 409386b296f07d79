"""The reference's default tensor-parallel cache layout in the port
(``kv_seq_shard=True``: every KV cache on its sequence dim over ``model``)
against the reference and the unsharded port, on the CPU.

* The partial modes of K5, K6 and K7 and the merge, through their plain
  versions (``kernels.ops.*_partials`` and ``merge_partials``): over N = 2
  and 4 rank slices of a cache (dense cells [r*S/N, (r+1)*S/N) of a ring
  that wrapped; paged in-block cells [r*bs/N, (r+1)*bs/N) of a table with a
  reused block, a short lane and an idle one), gathered and merged in
  (rank, split) order, against the whole-cache plain version and the JAX
  oracle (``repro.kernels.ref``): kv8 and kv4, f32 and bf16 arenas, G 2
  and 48, one pass and two. Tolerance: f32 outputs within 1e-5 of
  max|out|; with a softmax_out site at most 0.1 % of rows off by one
  softmax_out step x max|v| (a probability on a grid tie); the merge's
  int8 emit equal to K4's quantize of its f32 output, and to the oracle's
  emit except bytes whose values lie within ``TIE_REL`` of a rounding
  boundary (counted, at most 0.1 %).
* The 2-rank engine (``make_engine(dist=make_dist(mesh))``, a gloo group,
  reduced gemma2-2b on the reference's params and calibration): the
  modes of ``tests/test_torch_parallel.py`` plus paged f32 / kv16 caches
  give the unsharded engine's greedy tokens on both ranks (and, for f32
  and deploy, the reference's unsharded engine's); the first decode
  step's logits within 1e-5 of max|logits|; each rank holds half of every
  KV cache field, the block table whole.
* The launcher: ``serve --reduced --tp 2`` (the default layout) on the
  quickstart's flags for granite-20b (1 KV head on 2 ranks).
* The placement: the reference's specs, the block table whole, and the
  refusals where the rule falls back off the sequence dim.
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import Mode as JMode
from repro.core import QuantCtx as JQuantCtx
from repro.core import build_deploy as jbuild_deploy
from repro.core import peg_policy as jpeg_policy
from repro.core.pipeline import ptq as jptq
from repro.kernels import ref as jref
from repro.models import transformer as jtfm
from repro.parallel import sharding as jsh
from repro.runtime import Request as JRequest
from repro.runtime import serve_engine as jserve_engine
from repro.runtime.engine import make_engine as jmake_engine
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.int8_attend_decode import plan_dense_kv_splits
from repro_torch.kernels.nibble import pack_nibbles
from repro_torch.kernels.paged_attend_decode import plan_kv_splits
from repro_torch.kernels.peg_quant import peg_quantize_plain
from repro_torch.launch import serve
from repro_torch.launch.mesh import AbstractMesh, run_ranks
from repro_torch.models import transformer as tfm
from repro_torch.parallel import sharding as sh

import torch_tp_ranks as ranks

pytestmark = [pytest.mark.serve]

CPU = "cpu"
TIE_REL = 1e-5          # chip_smoke.TIE_REL: a value this close to a
#                         rounding boundary (in grid steps) is a tie


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the module (and for each spawned rank)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (a) the partial modes and the merge, plain versions, against the oracle
# ---------------------------------------------------------------------------

def _attend_check(got, want, smo_step, v_absmax):
    """chip_smoke's attend_check: 1e-5 of max|want|; with a softmax_out
    site at most 0.1 % of rows off by more, each by at most one step x
    max|v|."""
    err = (got - want).abs()
    tol = 1e-5 * float(want.abs().max())
    if smo_step is None:
        assert float(err.max()) <= tol
        return
    rows = err.amax(dim=-1)
    assert int((rows > tol).sum()) <= 1e-3 * rows.numel()
    assert float(err.max()) <= smo_step * v_absmax * (1 + 1e-5)


def _emit_ties(got, want_f32, s_o, z_o):
    """Bytes of ``got`` (an int8 emit) that differ from the emit of
    ``want_f32`` on the grid (s_o, z_o): each must sit at a rounding tie
    (the value within TIE_REL of a step of the boundary); returns how
    many differ."""
    want = peg_quantize_plain(want_f32.reshape(got.shape), s_o, z_o,
                              qmin=-128, qmax=127)
    off = got != want
    t = want_f32.reshape(got.shape)[off] / s_o
    edge = ((t - t.floor()) - 0.5).abs()
    assert bool((edge <= TIE_REL * t.abs().clamp_min(1.0)).all())
    assert int(off.sum()) <= 1e-3 * got.numel()
    return int(off.sum())


SHAPES = {"G2": (4, 2, 2, 16), "G48": (4, 1, 48, 8)}
SITES = {"one_pass": dict(sm_quant=torch.tensor([0.05, 128.0])),
         "two_pass": dict(sm_quant=torch.tensor([0.05, 128.0]),
                          smo_quant=torch.tensor([1 / 255, 0.0]))}


def _site_kw(passes):
    kw = dict(sm_quant=None, sm_qmin=0, sm_qmax=255, smo_quant=None,
              smo_qmin=0, smo_qmax=255)
    kw.update(SITES[passes])
    return kw


def _merged(fn, rank_args, n, kw, out_kw=None):
    """The rank slices' partials gathered along the split dim in rank
    order and merged (one pass, or statistics then the second launch)."""
    out_kw = out_kw or {}

    def gathered(mode, stats=None):
        return torch.cat([fn(*rank_args(r), mode=mode, stats=stats,
                             **kw(r)) for r in range(n)], dim=2)
    if kw(0)["smo_quant"] is None:
        return ops.merge_partials(gathered("one_pass"), mode="one_pass",
                                  **out_kw)
    stats = ops.merge_partials(gathered("stats"), mode="stats")
    return ops.merge_partials(gathered("emit", stats), mode="sum", **out_kw)


def _jnp(x):
    return jnp.asarray(x.float().numpy() if x.dtype == torch.bfloat16
                       else x.numpy())


def _jkw(kw):
    return {k: jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v
            for k, v in kw.items()}


def _check_merge(merged, emit_fn, whole, oracle, kw, v_abs):
    """``merged`` against the whole-cache plain version and the JAX
    oracle; the merge's emit against K4 on ``merged`` and the oracle's."""
    smo = kw["smo_quant"]
    step = None if smo is None else float(smo[0])
    for want in (whole, oracle):
        _attend_check(merged, want, step, v_abs)
    s_o = torch.tensor([float(merged.abs().max()) / 100])
    z_o = torch.tensor([3.0])
    emit = emit_fn(dict(out_scale=s_o, out_zp=z_o, qmin=-128, qmax=127))
    assert emit.dtype == torch.int8
    assert torch.equal(emit, peg_quantize_plain(
        merged.reshape(emit.shape), s_o, z_o, qmin=-128, qmax=127))
    if smo is None:
        _emit_ties(emit, oracle, s_o, z_o)


@pytest.mark.parametrize("passes", ["one_pass", "two_pass"])
@pytest.mark.parametrize("shape", ["G2", "G48"])
@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("n", [2, 4])
def test_dense_partials_merge_to_the_whole(n, kv_bits, shape, passes):
    """K5: a 64-cell ring that wrapped (slot j < 8 holds 64 + j), window
    40 (a second lane 30 positions in), lane 3 idle; each rank its 64 / N
    cells."""
    b, kv, g, hd = SHAPES[shape]
    S = 64
    rng = np.random.default_rng(S + kv_bits + g + n)
    hdp = hd // 2 if kv_bits == 4 else hd
    lim = 8 if kv_bits == 4 else 128
    k, v = (torch.from_numpy(rng.integers(-lim, lim, (b, S, kv, hd)).astype(
        np.int8)) for _ in range(2))
    if kv_bits == 4:
        k, v = pack_nibbles(k), pack_nibbles(v)
    assert k.shape[-1] == hdp
    k_s, v_s = (torch.from_numpy(rng.uniform(0.01, 0.05, (b, S, kv)).astype(
        np.float32)) for _ in range(2))
    pos = np.arange(S)
    k_pos = torch.from_numpy(np.tile(np.where(pos < 8, pos + S, pos),
                                     (b, 1)).astype(np.int32))
    q_pos = torch.tensor([S + 7, 30, S + 7, -1], dtype=torch.int32)
    q_q = torch.from_numpy(rng.integers(-127, 128, (b, kv, g, hd)).astype(
        np.int8))
    q_s = torch.from_numpy(rng.uniform(0.001, 0.004, (b, kv, g)).astype(
        np.float32))
    zp = dict(q_zp=torch.from_numpy(rng.integers(-9, 9, (b, kv, g)).astype(
        np.float32)), k_zp=torch.full((b, kv), 2.0),
              v_zp=torch.full((b, kv), -1.0))
    base = dict(window=40, logit_softcap=50.0, kv_bits=kv_bits, **zp,
                **_site_kw(passes))
    args = (q_q, q_s, k, k_s, v, v_s, k_pos, q_pos)
    whole = ops.int8_attend_decode(*args, **base)
    oracle = torch.from_numpy(np.array(jref.int8_attend_decode_ref(
        *map(_jnp, args), **_jkw(base))))
    m = S // n

    def rank_args(r):
        return (q_q, q_s, *(t[:, r * m:(r + 1) * m]
                            for t in (k, k_s, v, v_s, k_pos)), q_pos)
    assert plan_dense_kv_splits(b, kv, m)[0] >= 1
    merged = _merged(ops.int8_attend_decode_partials, rank_args, n,
                     lambda r: base)
    v_abs = float((v.float().abs().max() + 1) * v_s.max()) * (
        16 if kv_bits == 4 else 1)
    _check_merge(merged, lambda o: _merged(
        ops.int8_attend_decode_partials, rank_args, n, lambda r: base, o),
        whole, oracle, base, v_abs)


def _paged_case(rng, b, kv, g, hd, bs):
    """A table of 6 blocks a lane (48 cells, s_cap 40: the ring wrapped on
    lanes 0 and 2), block 0 of lane 0 reused as lane 2's (a shared
    block), an unmapped tail (lane 1, short), an idle lane 3."""
    nb, n_blocks = 6, b * 6 + 3
    table = rng.permutation(n_blocks)[:b * nb].reshape(b, nb).astype(
        np.int32)
    table[2, 0] = table[0, 0]
    table[1, 4:] = -1
    q_pos = torch.tensor([40 + 13, 17, 40 + 13, -1], dtype=torch.int32)
    return torch.from_numpy(table), q_pos, n_blocks


@pytest.mark.parametrize("passes", ["one_pass", "two_pass"])
@pytest.mark.parametrize("shape", ["G2", "G48"])
@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("n", [2, 4])
def test_paged_int8_partials_merge_to_the_whole(n, kv_bits, shape, passes):
    """K6: blocks of 8 cells, rank r holding in-block cells [r*8/N,
    (r+1)*8/N) (cell_lo > 0 from rank 1 on); the block table whole."""
    b, kv, g, hd = SHAPES[shape]
    bs = 8
    rng = np.random.default_rng(bs + kv_bits + g + n)
    table, q_pos, n_blocks = _paged_case(rng, b, kv, g, hd, bs)
    lim = 8 if kv_bits == 4 else 128
    k, v = (torch.from_numpy(rng.integers(
        -lim, lim, (n_blocks, bs, kv, hd)).astype(np.int8)) for _ in range(2))
    if kv_bits == 4:
        k, v = pack_nibbles(k), pack_nibbles(v)
    k_s, v_s = (torch.from_numpy(rng.uniform(
        0.01, 0.05, (n_blocks, bs, kv)).astype(np.float32)) for _ in range(2))
    q_q = torch.from_numpy(rng.integers(-127, 128, (b, kv, g, hd)).astype(
        np.int8))
    q_s = torch.from_numpy(rng.uniform(0.001, 0.004, (b, kv, g)).astype(
        np.float32))
    base = dict(s_cap=40, window=40, logit_softcap=50.0, kv_bits=kv_bits,
                v_zp=torch.full((b, kv), 2.0), **_site_kw(passes))
    args = (q_q, q_s, k, k_s, v, v_s, table, q_pos)
    whole = ops.paged_int8_attend_decode(*args, **base)
    cols = table[:, :5]                  # the columns s_cap 40 reaches
    oracle = torch.from_numpy(np.array(jref.paged_int8_attend_decode_ref(
        *map(_jnp, (q_q, q_s, k, k_s, v, v_s, cols, q_pos)), **_jkw(base))))
    c = bs // n

    def rank_args(r):
        return (q_q, q_s, *(t[:, r * c:(r + 1) * c] for t in (k, k_s, v,
                                                              v_s)),
                table, q_pos)

    def kw(r):
        return dict(base, block_size=bs, cell_lo=r * c)
    assert plan_kv_splits(b, kv, 5, c)[0] >= 1
    merged = _merged(ops.paged_int8_attend_decode_partials, rank_args, n, kw)
    v_abs = float((v.float().abs().max() + 2) * v_s.max()) * (
        16 if kv_bits == 4 else 1)
    _check_merge(merged, lambda o: _merged(
        ops.paged_int8_attend_decode_partials, rank_args, n, kw, o),
        whole, oracle, base, v_abs)


@pytest.mark.parametrize("passes", ["one_pass", "two_pass"])
@pytest.mark.parametrize("shape", ["G2", "G48"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [2, 4])
def test_paged_float_partials_merge_to_the_whole(n, dtype, shape, passes):
    """K7 on f32 and bf16 arenas (bf16 values, held as f32 by the oracle),
    the layout of the K6 case."""
    b, kv, g, hd = SHAPES[shape]
    bs = 8
    rng = np.random.default_rng(bs + g + n + len(dtype))
    table, q_pos, n_blocks = _paged_case(rng, b, kv, g, hd, bs)
    tdt = getattr(torch, dtype)
    q = torch.from_numpy((rng.standard_normal((b, kv, g, hd)) * 0.3).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal(
        (n_blocks, bs, kv, hd)).astype(np.float32)).to(tdt)
        for _ in range(2))
    base = dict(s_cap=40, window=None, logit_softcap=50.0,
                **_site_kw(passes))
    args = (q, k, v, table, q_pos)
    whole = ops.paged_attend_decode(*args, **base)
    oracle = torch.from_numpy(np.array(jref.paged_attend_decode_ref(
        *map(_jnp, (q, k, v, table[:, :5], q_pos)), **_jkw(base))))
    c = bs // n

    def rank_args(r):
        return (q, k[:, r * c:(r + 1) * c], v[:, r * c:(r + 1) * c], table,
                q_pos)

    def kw(r):
        return dict(base, block_size=bs, cell_lo=r * c)
    merged = _merged(ops.paged_attend_decode_partials, rank_args, n, kw)
    _check_merge(merged, lambda o: _merged(
        ops.paged_attend_decode_partials, rank_args, n, kw, o),
        whole, oracle, base, float(v.float().abs().max()))


def test_idle_lane_is_the_mean_of_every_ranks_cells():
    """An idle lane (q_pos -1, every cell masked on every rank) gives the
    mean of all cells' V over the ranks, as the whole-cache kernel's."""
    rng = np.random.default_rng(3)
    b, kv, g, hd, S, n = 2, 1, 2, 8, 32, 4
    v = torch.from_numpy(rng.standard_normal((1, S, kv, hd)).astype(
        np.float32)).repeat(2, 1, 1, 1)
    k = torch.zeros_like(v)
    table = torch.arange(b * 4, dtype=torch.int32).reshape(b, 4)
    arena = lambda t: t.reshape(b * 4, 8, kv, hd)       # noqa: E731
    q = torch.zeros(b, kv, g, hd)
    q_pos = torch.tensor([-1, -1], dtype=torch.int32)
    kw = dict(s_cap=S, window=None, logit_softcap=None, **_site_kw(
        "one_pass"), )
    kw["sm_quant"] = None

    def rank_args(r):
        return (q, arena(k)[:, r * 2:(r + 1) * 2],
                arena(v)[:, r * 2:(r + 1) * 2], table, q_pos)
    merged = _merged(ops.paged_attend_decode_partials, rank_args, n,
                     lambda r: dict(kw, block_size=8, cell_lo=2 * r))
    mean = v[0].mean(dim=0)                              # (kv, hd)
    assert torch.allclose(merged, mean[None, :, None].expand_as(merged),
                          atol=1e-6)
    assert torch.allclose(merged, ops.paged_attend_decode(
        q, arena(k), arena(v), table, q_pos, **kw), atol=1e-6)


def test_partial_modes_refuse_what_they_cannot_merge():
    """one_pass takes no softmax_out site, stats / emit need it, and only
    emit takes the global statistics; a cell window must fit its block."""
    q = torch.zeros(1, 1, 2, 8)
    arena = torch.zeros(2, 4, 1, 8)
    table = torch.zeros(1, 2, dtype=torch.int32)
    q_pos = torch.zeros(1, dtype=torch.int32)
    kw = dict(s_cap=8, block_size=8, cell_lo=0)
    smo = torch.tensor([1 / 255, 0.0])
    for mode, extra in (("one_pass", dict(smo_quant=smo)), ("stats", {}),
                        ("emit", dict(smo_quant=smo)), ("sideways", {})):
        with pytest.raises(ValueError, match="partials"):
            ops.paged_attend_decode_partials(q, arena, arena, table, q_pos,
                                             mode=mode, **kw, **extra)
    with pytest.raises(ValueError, match="do not fit a block"):
        ops.paged_attend_decode_partials(q, arena, arena, table, q_pos,
                                         mode="one_pass", s_cap=8,
                                         block_size=8, cell_lo=6)
    with pytest.raises(ValueError, match="one_pass, stats or sum"):
        ops.merge_partials(torch.zeros(1, 1, 2, 2, 10), mode="merge")


# ---------------------------------------------------------------------------
# (b) the engine on a 2-rank gloo group, caches on the sequence dim
# ---------------------------------------------------------------------------

def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def seq_models():
    """Reduced gemma2-2b on the reference's params and calibration (as
    ``tests/test_torch_parallel.py``'s ``models``); one spawn of 2 CPU ranks
    running ``torch_tp_ranks.kvseq_scenarios``, while this process runs
    the reference's unsharded ``make_engine`` + ``serve_engine`` (f32 and
    deploy, dense kv16)."""
    jcfg = jget_config("gemma2-2b").reduced()
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
        ranks.kvseq_scenarios, 2, (_np_tree(jstacked), _np_tree(jshared)),
        device=CPU, threads=1)))
    spawn.start()
    try:
        jpacked, jacts = jbuild_deploy(jcfg, jstacked, jpeg_policy(4),
                                       jshared)

        def jctx():
            return JQuantCtx(policy=jpeg_policy(4), mode=JMode.DEPLOY,
                             act_state=jshared, deploy_acts=jacts)
        ref = {}
        for tag, jparams, jc in (("f32", jstacked, None),
                                 ("deploy", jpacked, jctx)):
            eng = jmake_engine(jcfg, jparams, batch_slots=2,
                               prompt_pad_len=ranks.PAD,
                               max_len=ranks.MAX_LEN, dtype=jnp.float32,
                               ctx_factory=jc)
            reqs = ranks.mk_reqs(JRequest, jcfg.vocab_size)
            jserve_engine(eng, reqs)
            ref[tag] = [r.tokens_out for r in reqs]
    finally:
        spawn.join(timeout=600)
    assert not spawn.is_alive() and got, "the ranks did not report"
    return dict(ranks=got[0], ref=ref)


SEQ_MODES = ["f32", "f32_onehot", "apply", "deploy", "deploy_kv8",
             "deploy_paged_kv8", "f32_paged", "deploy_paged", "armed_apply",
             "armed_deploy_paged_kv8"]


@pytest.mark.parametrize("mode", SEQ_MODES)
def test_seq_engine_tokens(seq_models, mode):
    """Both ranks emit the unsharded engine's greedy tokens (f32 and
    deploy also the reference's unsharded engine's): dense f32 / kv16 /
    kv8 caches and paged f32, kv16 (K7) and kv8 (K6) arenas, each rank
    holding half of every cache's cells."""
    r0, r1 = seq_models["ranks"]
    un = {"f32_onehot": "f32_un"}.get(mode, mode + "_un")
    assert r0[mode] == r1[mode] == r0[un] == r1[un]
    if mode in seq_models["ref"]:
        assert r0[mode] == seq_models["ref"][mode]


def test_seq_first_decode_logits_within_bound(seq_models):
    """f32: the first decode step's logits within 1e-5 of max|logits| of
    the unsharded run's, the same bytes on both ranks."""
    r0, r1 = seq_models["ranks"]
    want = r0["logits_un"]
    gap = float((r0["logits"] - want).abs().max() / want.abs().max())
    assert gap <= 1e-5, gap
    assert torch.equal(r0["logits"], r1["logits"])


@pytest.mark.parametrize("tag", ["f32", "kv8", "kv4", "paged_f32",
                                 "paged_kv8"])
def test_seq_rank_holds_half_of_every_kv_field(seq_models, tag):
    """Every payload, scale and position field: half the whole's bytes on
    each rank; the block table whole on both."""
    for r in seq_models["ranks"]:
        placed, whole = r["cache_bytes"][tag]
        assert set(placed) == set(whole)
        for path, n in placed.items():
            if path == "block_table":
                assert n == whole[path]
            else:
                assert 2 * n == whole[path], path
        kv = [p for p in placed if p != "block_table"]
        assert 2 * sum(placed[p] for p in kv) == sum(whole[p] for p in kv)


def test_seq_put_arrays_equal_on_both_ranks(seq_models):
    r0, r1 = seq_models["ranks"]
    assert len(r0["masks"]) == len(r1["masks"]) > 0
    for a, b in zip(r0["masks"], r1["masks"]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# (c) the launcher and the placement
# ---------------------------------------------------------------------------

QUICK = ("--reduced --requests 6 --prompt-len 24 --new-tokens 6 --max-len 64 "
         "--quantize --deploy-int8 --kv-bits 8 --scheduler continuous "
         "--paged-kv --block-size 8 --prefill-chunk 8 --parity").split()


def test_launcher_tp2_serves_granite_in_the_default_layout(capsys):
    """granite-20b (48 query heads on 1 KV head at full width; 4 on 1
    reduced), which the KV-head layout refuses: ``--tp 2`` serves the
    unsharded run's greedy tokens on both ranks and prints its lines, each
    rank holding half of the peak KV cache."""
    argv = ["--arch", "granite-20b"] + QUICK
    un, tp = [], []
    serve.main(argv, device=CPU, report=un)
    out_un = capsys.readouterr().out
    serve.main(argv + ["--tp", "2"], device=CPU, report=tp)
    out_tp = capsys.readouterr().out
    assert [r["tokens"] for r in tp] == [un[0]["tokens"]] * 2
    assert out_tp.count("[parity] OK") == 3
    lines_un, lines_tp = out_un.splitlines(), out_tp.splitlines()
    assert len(lines_un) == len(lines_tp)
    for a, b in zip(lines_un, lines_tp):
        if a.startswith("[serve:"):
            assert b.startswith(", ".join(a.split(", ")[:3]))
            kib = [int(x.split("peak kv-cache ")[1].split(" ")[0])
                   for x in (a, b)]
            assert abs(2 * kib[1] - kib[0]) <= 1, kib
        else:
            assert a == b


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


def _dists(shape, kv_seq_shard=True):
    axes = ("data", "model")
    return (jsh.make_dist(jsh.make_abstract_mesh(shape, axes)),
            dataclasses.replace(sh.make_dist(AbstractMesh(shape, axes)),
                                kv_seq_shard=kv_seq_shard))


@pytest.mark.parametrize("kv_bits,paged", [(16, False), (8, False),
                                           (4, True), (8, True)])
@pytest.mark.parametrize("n", [2, 4])
def test_seq_specs_are_the_references_with_the_table_whole(n, kv_bits,
                                                           paged):
    """``make_seq_cache_specs`` equals the reference's ``make_cache_specs``
    on every KV field (the sequence dim on ``model``) and keeps the block
    table whole (the reference cuts its block dim)."""
    cfg, jcfg = get_config("gemma2-2b").reduced(), \
        jget_config("gemma2-2b").reduced()
    kw = dict(dtype=torch.float32, kv_bits=kv_bits, device="meta")
    jkw = dict(dtype=jnp.float32, kv_bits=kv_bits)
    if paged:
        kw.update(paged=True, block_size=8)
        jkw.update(paged=True, block_size=8)
    cache = tfm.init_cache(cfg, 4, 64, **kw)
    jcache = jax.eval_shape(lambda: jtfm.init_cache(jcfg, 4, 64, **jkw))
    jd, d = _dists((1, n))
    flat, _ = jax.tree_util.tree_flatten_with_path(jcache)
    want = {jsh._leaf_path(p): tuple(jsh.cache_spec_for(
        leaf.shape, jd, has_scan_dim="scan" in jsh._leaf_path(p)))
        for p, leaf in flat}
    specs = _port_specs(cache, sh.make_seq_cache_specs(cache, d))
    assert set(specs) == set(want)
    for path, spec in specs.items():
        if path == "block_table":
            assert spec == () and "model" in want[path]
        else:
            assert spec == want[path] and "model" in spec, path


def test_seq_placement_refuses_cells_the_ranks_do_not_divide():
    """A 30-cell dense cache (or blocks of 3) on 4 ranks: the reference's
    rule falls back off the sequence dim, which the port does not execute,
    and says so; the KV-head layout still refuses granite's 1 KV head."""
    cfg = get_config("gemma2-2b").reduced()
    _, d = _dists((1, 4))
    for kw in (dict(), dict(paged=True, block_size=3)):
        cache = tfm.init_cache(cfg, 2, 30, dtype=torch.float32,
                               device="meta", **kw)
        with pytest.raises(NotImplementedError,
                           match="cells on 4 ranks .* not yet ported"):
            sh.make_seq_cache_specs(cache, d)
    _, kvh = _dists((1, 2), kv_seq_shard=False)
    with pytest.raises(NotImplementedError, match="1 KV heads on 2 ranks"):
        tfm.check_tp(get_config("granite-20b").reduced(), kvh)
    tfm.check_tp(get_config("granite-20b").reduced(), _dists((1, 2))[1])
