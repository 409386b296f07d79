"""Rank bodies of ``tests/test_torch_parallel.py`` (the KV-head cache
layout) and ``tests/test_torch_kvseq.py`` (the sequence layout, the
default): functions that ``repro_torch.launch.mesh.run_ranks`` spawns on a
CPU gloo group. No JAX here (every rank would import it): the tests hand
the reference's params and calibration across as numpy trees."""
import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.convert import act_state_from_jax, params_from_jax
from repro_torch.core import Mode, QuantCtx, build_deploy, peg_policy
from repro_torch.models import transformer as tfm
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import (make_cache_shardings,
                                           param_spec_for, place_cache,
                                           tree_leaves_with_path)
from repro_torch.runtime import Request, make_engine, serve_engine
from repro_torch.runtime.steps import make_admit_step, make_decode_step

MAX_LEN, PAD = 32, 8
SPEC = [(4, 2), (8, 6), (3, 1), (6, 4)]


def mk_reqs(cls, vocab, seed=21, spec=SPEC):
    rng = np.random.RandomState(seed)
    return [cls(rid=i, prompt=rng.randint(1, vocab, size=n).astype(np.int32),
                max_new_tokens=q)
            for i, (n, q) in enumerate(spec)]


def _tokens(cfg, params, dist, dev, ctx=None, masks=None, **kw):
    """The reference test's ``run``: make_engine + serve_engine over
    ``SPEC`` on 2 lanes; ``masks`` (a list) records every host array the
    engine puts on the device."""
    eng = make_engine(cfg, params, batch_slots=2, prompt_pad_len=PAD,
                      max_len=MAX_LEN, dtype=torch.float32, dist=dist,
                      ctx_factory=ctx, device=dev, **kw)
    if masks is not None:
        put = eng._put

        def recorded(x):
            masks.append(np.array(x, copy=True))
            return put(x)
        eng._put = recorded
    reqs = mk_reqs(Request, cfg.vocab_size)
    serve_engine(eng, reqs)
    return [r.tokens_out for r in reqs]


def _first_decode_logits(cfg, params, dist, dev, ctx=None):
    """Logits of the first decode step after an admit of two prompts,
    through the serving steps (placed params and cache under ``dist``)."""
    admit = make_admit_step(cfg, ctx_factory=ctx, dist=dist)
    decode = make_decode_step(cfg, ctx_factory=ctx, dist=dist)
    cache = place_cache(tfm.init_cache(cfg, 2, MAX_LEN, dtype=torch.float32,
                                       device=dev), dist)
    rng = np.random.RandomState(5)
    toks = torch.as_tensor(rng.randint(1, cfg.vocab_size, (2, PAD)))
    pos = torch.arange(PAD, dtype=torch.int32).expand(2, PAD).contiguous()
    logits, cache = admit(params, toks, pos, torch.ones(2, dtype=torch.bool),
                          cache)
    nxt = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    step_pos = torch.full((2, 1), PAD, dtype=torch.int32)
    return decode(params, nxt, step_pos, cache)[0]


def engine_scenarios(dist, dev, jparams, jshared):
    """The reference's sharded engine scenario (``tests/test_engine.py``'s
    ``SHARDED_SCRIPT``) on this rank with the caches on their KV heads
    (``kv_seq_shard=False``), with more modes: greedy tokens of the
    sharded engine in f32, with the one-hot embed, in APPLY fake-quant,
    and on the deploy path (dense kv16 as the reference, kv8 and paged
    kv8), each beside the same engine unsharded on this rank; the first
    decode step's logits sharded and unsharded; the host arrays the
    engine put; this rank's bytes of every leaf placed on ``model`` (by
    path) and the whole bytes of each; APPLY and deploy (paged kv8)
    engines with quant telemetry armed, their tokens and quant-health
    reports, sharded and unsharded."""
    return _scenarios(dataclasses.replace(dist, kv_seq_shard=False), dev,
                      jparams, jshared)


def kvseq_scenarios(dist, dev, jparams, jshared):
    """:func:`engine_scenarios`' modes in the default layout (every cache
    on its sequence dim, ``dist`` as ``run_ranks`` builds it), plus a paged
    f32 cache (K7's path), and per mode this rank's resident cache bytes
    (the KV fields; the block table apart) against the unsharded cache's."""
    assert dist.kv_seq_shard
    out = _scenarios(dist, dev, jparams, jshared, seq=True)
    cfg = get_config("gemma2-2b").reduced()
    out["cache_bytes"] = {}
    for tag, kw in (("f32", {}), ("kv8", {"kv_bits": 8}),
                    ("kv4", {"kv_bits": 4}),
                    ("paged_f32", {"paged": True, "block_size": 4}),
                    ("paged_kv8", {"kv_bits": 8, "paged": True,
                                   "block_size": 4})):
        whole = tfm.init_cache(cfg, 2, MAX_LEN, dtype=torch.float32,
                               device=dev, **kw)
        out["cache_bytes"][tag] = tuple(
            {path: x.numel() * x.element_size()
             for path, x in tree_leaves_with_path(c)}
            for c in (place_cache(whole, dist), whole))
    return out


def _scenarios(dist, dev, jparams, jshared, seq=False):
    cfg = get_config("gemma2-2b").reduced()
    params = params_from_jax(jparams, dev)
    shared = act_state_from_jax(jshared, dev)
    pol = peg_policy(4)
    packed, acts = build_deploy(cfg, params, pol, shared)

    memo = {}       # the unsharded runs' weight memo (a serving session's)

    def deploy_ctx():
        return QuantCtx(policy=pol, mode=Mode.DEPLOY, act_state=shared,
                        deploy_acts=acts, weight_cache=memo)

    def apply_ctx():
        return QuantCtx(policy=pol, mode=Mode.APPLY, act_state=shared,
                        weight_cache=memo)

    out = {"masks": []}
    out["f32"] = _tokens(cfg, params, dist, dev, masks=out["masks"])
    out["f32_un"] = _tokens(cfg, params, None, dev)
    onehot = dataclasses.replace(dist, onehot_embed=True)
    out["f32_onehot"] = _tokens(cfg, params, onehot, dev)
    out["apply"] = _tokens(cfg, params, dist, dev, apply_ctx)
    out["apply_un"] = _tokens(cfg, params, None, dev, apply_ctx)
    for tag, kw in (("deploy", {}), ("deploy_kv8", {"kv_bits": 8}),
                    ("deploy_paged_kv8", {"kv_bits": 8, "paged": True,
                                          "block_size": 4})):
        out[tag] = _tokens(cfg, packed, dist, dev, deploy_ctx, **kw)
        out[tag + "_un"] = _tokens(cfg, packed, None, dev, deploy_ctx, **kw)
    if seq:
        kw = {"paged": True, "block_size": 4}
        out["f32_paged"] = _tokens(cfg, params, dist, dev, **kw)
        out["f32_paged_un"] = _tokens(cfg, params, None, dev, **kw)
        out["deploy_paged"] = _tokens(cfg, packed, dist, dev, deploy_ctx,
                                      **kw)
        out["deploy_paged_un"] = _tokens(cfg, packed, None, dev, deploy_ctx,
                                         **kw)
    # quant telemetry through the engine: the armed steps' site vectors
    # folded over the ranks into a QuantHealth, against the unsharded
    # engine's
    from repro_torch.runtime.telemetry import QuantHealth
    for tag, p, ctx, kw in (
            ("armed_apply", params, apply_ctx, {}),
            ("armed_deploy_paged_kv8", packed, deploy_ctx,
             {"kv_bits": 8, "paged": True, "block_size": 4})):
        health = {}
        for key, d in ((tag, dist), (tag + "_un", None)):
            health[key] = QuantHealth()
            out[key] = _tokens(cfg, p, d, dev, ctx, quant_telemetry=True,
                               telemetry_sink=health[key].update, **kw)
            out[key + "_report"] = health[key].report()
    placed = params_from_jax(jparams, dev, dist=dist)
    with torch.no_grad():
        out["logits"] = _first_decode_logits(cfg, placed, dist, dev)
        out["logits_un"] = _first_decode_logits(cfg, params, None, dev)
    whole = dict(tree_leaves_with_path(params))
    out["model_bytes"] = {
        path: (x.numel() * x.element_size(),
               whole[path].numel() * whole[path].element_size())
        for path, x in tree_leaves_with_path(placed)
        if dist.tp_axis in _names(param_spec_for(
            path, tuple(whole[path].shape), dist,
            has_scan_dim="scan" in path))}
    cache = tfm.init_cache(cfg, 4, MAX_LEN, dtype=torch.float32, kv_bits=8,
                           paged=True, block_size=4, device=dev)
    out["cache_placed"] = {p: tuple(x.shape) for p, x in
                           tree_leaves_with_path(make_cache_shardings(
                               cache, dist))}
    out["collective_s"] = coll.seconds
    out["collectives"] = collective_cases(dist)
    return out


def _names(spec):
    names = set()
    for a in spec:
        names.update(a if isinstance(a, tuple) else (a,))
    return names


def collective_cases(dist):
    """The collectives on this rank: gathers of int8 / bf16 / f32 slices,
    a bf16 sum reduced in f32, a broadcast from rank 1, a host max, and
    the identity without ``dist``."""
    r = coll.tp_index(dist)
    i8 = torch.full((2, 3), r - 100, dtype=torch.int8)
    bf = torch.full((2, 3), 1.0 + r / 256, dtype=torch.bfloat16)
    f32 = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * r
    small = torch.full((4,), 1.0 + r * 2.0 ** -7, dtype=torch.bfloat16)
    return {
        "gather_i8": coll.all_gather(i8, dist, dim=-1),
        "gather_bf16": coll.all_gather(bf, dist, dim=0),
        "gather_f32": coll.all_gather(f32, dist, dim=1),
        "sum_bf16": coll.all_reduce_sum(small, dist),
        "sum_f32": coll.all_reduce_sum(f32, dist),
        "broadcast": coll.broadcast(f32, dist, src=1),
        "agree": coll.agree_max([r, -r, 7], dist),
        "identity": coll.all_gather(f32, None) is f32
        and coll.all_reduce_sum(f32, None) is f32,
    }


def moe_ep_scenarios(dist, dev, blocks, launcher):
    """The MoE blocks under ``--tp`` on this rank (``tests/
    test_torch_moe_ep.py``). ``blocks``: {name: (MoEConfig fields, whole
    params as numpy, {shape tag: x (B, T, D) as numpy})}, each placed by
    ``make_param_shardings`` (E/N experts, or all of them on a d_ff slice
    where N does not divide E) and run through ``transformer._moe_sharded``
    twice, recording every dispatch's integers; ``launcher``: [(name,
    arch, argv)] served by the launcher's serve body on this rank
    (``serve._serve_rank``). Returns the outputs, the dispatches, each
    block's placed and whole expert bytes and, per name, the rank's report
    with rank 0's output and the arch's expert bytes (``init_params``
    placed)."""
    import types
    from repro_torch.launch import serve
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import make_param_shardings
    out = {"blocks": {}, "again": {}, "dispatch": {}, "expert_bytes": {},
           "launcher": {}}
    real = moe._dispatch_indices

    def nbytes(tree):
        return {path: x.numel() * x.element_size()
                for path, x in tree_leaves_with_path(tree)}

    for name, (kw, p, xs) in blocks.items():
        cfg = types.SimpleNamespace(moe=moe.MoEConfig(**kw))
        whole = {k: torch.from_numpy(v).to(dev) for k, v in p.items()}
        placed = make_param_shardings({"moe": whole}, dist)["moe"]
        out["expert_bytes"][name] = (nbytes(placed), nbytes(whole))
        for tag, x in xs.items():
            log = []

            def dispatch(*a, **k):
                got = real(*a, **k)
                log.append(tuple(t.cpu() for t in got))
                return got
            moe._dispatch_indices = dispatch
            try:
                xt = torch.from_numpy(x).to(dev)
                y = tfm._moe_sharded(cfg, placed, xt, dist)
                out["again"][name, tag] = torch.equal(
                    y, tfm._moe_sharded(cfg, placed, xt, dist))
            finally:
                moe._dispatch_indices = real
            out["blocks"][name, tag] = y.cpu()
            out["dispatch"][name, tag] = log[0]
    for name, arch, argv in launcher:
        text, _, info = serve._serve_rank(dist, dev, argv, None)
        cfg = get_config(arch).reduced()
        whole = tfm.init_params(cfg, 0, stacked=True, dtype=torch.float32,
                                device=dev)
        placed = make_param_shardings(whole, dist)
        experts = [nbytes(t) for t in (placed, whole)]
        info.update(text=text, expert_bytes=tuple(
            sum(n for path, n in b.items() if "/moe/w_" in path)
            for b in experts))
        out["launcher"][name] = info
    return out


def cpu_drawn_serve(dist, dev, argv):
    """The launcher's serve body on this rank from CPU-drawn weights
    (``chip_smoke.cpu_drawn_params``: a card run and a CPU run serve the
    same model): the rank's greedy tokens and kernel launches."""
    from chip_smoke import cpu_drawn_params
    from repro_torch.launch import serve
    with cpu_drawn_params():
        _, _, info = serve._serve_rank(dist, dev, argv, None)
    return info["tokens"], info["launches"]


# ---------------------------------------------------------------------------
# The serving flags under --tp (tests/test_torch_tp_flags.py)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def flag_counters():
    """chip_smoke's counters while the block runs: ``BlockPool.cow``
    calls, the copies they ask for and ``cache_copy_block`` calls
    (``cow``), the swap payloads' bytes and host times (``swaps``) and the
    files opened for writing (``files``)."""
    from chip_smoke import _cow_counts, _files_written, _swap_times
    with _cow_counts() as cow, _swap_times() as swaps, \
            _files_written() as files:
        yield {"cow": cow, "swaps": swaps, "files": files}


def serve_runs(dist, dev, runs):
    """Each ``{name: argv}`` of ``runs`` through the launcher's serve body
    on this rank (``serve._serve_rank``) under :func:`flag_counters`:
    {name: (rank 0's output, the rank's report, the counters)}."""
    from repro_torch.launch import serve
    got = {}
    for name, argv in runs.items():
        with flag_counters() as counts:
            text, _, info = serve._serve_rank(dist, dev, argv, None)
        got[name] = (text, info, counts)
    return got


def flag_scenarios(dist, dev, runs):
    """``runs`` through :func:`serve_runs`, then the units of the flags'
    device halves on this rank: the armed steps' raw site vectors
    (:func:`site_rule_scenarios`), KV scale stats over placed caches
    (:func:`kv_scale_scenarios`), the block copy / gather / scatter and
    the whole-cells read on placed arenas (:func:`block_op_scenarios`) and
    the weight grids of a rank's slice (:func:`weight_grid_scenarios`),
    each in both cache layouts where the layout matters."""
    layouts = {"seq": dist,
               "kvhead": dataclasses.replace(dist, kv_seq_shard=False)}
    return {"runs": serve_runs(dist, dev, runs),
            "sites": {(lay, mode): site_rule_scenarios(d, dev, mode)
                      for lay, d in layouts.items()
                      for mode in ("apply", "deploy")},
            "kv_scales": {lay: kv_scale_scenarios(d, dev)
                          for lay, d in layouts.items()},
            "blocks": {lay: block_op_scenarios(d, dev)
                       for lay, d in layouts.items()},
            "grids": weight_grid_scenarios(dist, dev)}


def _host_tel(tel):
    return ({k: v.detach().cpu().numpy().copy() for k, v in tel.items()},
            set(getattr(tel, "parts", ())))


def site_rule_scenarios(dist, dev, mode):
    """Reduced gemma2-2b calibrated as the launcher calibrates it (APPLY
    fake-quant, or ``mode="deploy"``: the integer path with an int8 KV
    cache), one admit (2 lanes of 8 tokens), one chunk (4 tokens appended)
    and one decode step through the armed steps on a paged cache, unsharded
    and on this rank's slices (``dist``'s layout): per step, the unsharded
    site vectors and the rank's raw ones (not folded) with the sites it
    marks as its part of a cut tensor."""
    import io as io_
    from contextlib import redirect_stdout
    from repro_torch.launch import serve
    from repro_torch.parallel.sharding import (make_param_shardings,
                                               shard_ctx_factory)
    from repro_torch.runtime.steps import make_chunk_prefill_step
    cfg = get_config("gemma2-2b").reduced()
    argv = ["--arch", "gemma2-2b", "--reduced", "--quantize",
            "--prompt-len", "8"]
    kv_bits = 16
    if mode == "deploy":
        argv += ["--deploy-int8", "--kv-bits", "8"]
        kv_bits = 8
    args = serve.build_parser().parse_args(argv)
    params = tfm.init_params(cfg, 0, dtype=torch.float32, device=dev)
    with redirect_stdout(io_.StringIO()):
        params, ctx = serve._quantize(cfg, args, params, torch.float32, dev)
    placed = make_param_shardings(params, dist)
    rank_ctx = shard_ctx_factory(cfg, params, placed, ctx, dist)
    rng = np.random.RandomState(4)
    toks = torch.as_tensor(rng.randint(1, cfg.vocab_size, (2, 8)))
    pos = torch.arange(8, dtype=torch.int32).expand(2, 8).contiguous()
    ctoks = torch.as_tensor(rng.randint(1, cfg.vocab_size, (2, 4)))
    cpos = (8 + torch.arange(4, dtype=torch.int32)).expand(2, 4).contiguous()
    out = {}
    for tag, p, c, d in (("un", params, ctx, None),
                         ("rank", placed, rank_ctx, dist)):
        kw = dict(ctx_factory=c, dist=d, quant_telemetry=True)
        admit, decode = make_admit_step(cfg, **kw), make_decode_step(cfg, **kw)
        chunk = make_chunk_prefill_step(cfg, **kw)
        cache = tfm.init_cache(cfg, 2, MAX_LEN, dtype=torch.float32,
                               kv_bits=kv_bits, paged=True, block_size=4,
                               device=dev)
        cache = place_cache(cache, d)
        steps = []
        with torch.no_grad():
            logits, cache, tel = admit(p, toks, pos,
                                       torch.ones(2, dtype=torch.bool), cache)
            steps.append(_host_tel(tel))
            _, cache, tel = chunk(p, ctoks, cpos,
                                  torch.zeros(2, dtype=torch.bool), cache)
            steps.append(_host_tel(tel))
            nxt = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            _, cache, tel = decode(p, nxt, torch.full((2, 1), 12,
                                                      dtype=torch.int32),
                                   cache)
            steps.append(_host_tel(tel))
        out[tag] = steps
    return out


def _scale_stats(cache, dist):
    from repro_torch.runtime.telemetry import QuantHealth
    qh = QuantHealth()
    qh.update_kv_scales(cache, dist)
    return qh.kv_scale_stats


def kv_scale_scenarios(dist, dev):
    """The KV cache's scale stats (``QuantHealth.update_kv_scales``) of
    int8 and int4 caches, dense and paged, written by an admit of reduced
    gemma2-2b (no ctx: every token's grid is its own, so the scales
    differ), of the whole cache and of this rank's placed slice under
    ``dist``: {(kv bits, paged): (whole's, the rank's)}."""
    cfg = get_config("gemma2-2b").reduced()
    params = tfm.init_params(cfg, 0, dtype=torch.float32, device=dev)
    admit = make_admit_step(cfg)
    rng = np.random.RandomState(6)
    toks = torch.as_tensor(rng.randint(1, cfg.vocab_size, (2, 12)))
    pos = torch.arange(12, dtype=torch.int32).expand(2, 12).contiguous()
    got = {}
    for kv_bits in (8, 4):
        for paged in (False, True):
            cache = tfm.init_cache(cfg, 2, MAX_LEN, dtype=torch.float32,
                                   kv_bits=kv_bits, paged=paged,
                                   block_size=4, device=dev)
            with torch.no_grad():
                _, cache = admit(params, toks, pos,
                                 torch.ones(2, dtype=torch.bool), cache)
            got[kv_bits, paged] = (_scale_stats(cache, None),
                                   _scale_stats(place_cache(cache, dist),
                                                dist))
    return got


def _random_paged(cfg, kv_bits, dev, seed):
    """A paged cache of reduced gemma2-2b (8 blocks of 4 cells) with every
    field filled from ``seed`` in its own dtype."""
    cache = tfm.init_cache(cfg, 2, 16, dtype=torch.float32, kv_bits=kv_bits,
                           paged=True, block_size=4, num_blocks=8,
                           device=dev)
    gen = torch.Generator().manual_seed(seed)

    def fill(x):
        if x.dtype.is_floating_point:
            x.copy_(torch.randn(x.shape, generator=gen))
        else:
            info = torch.iinfo(x.dtype)
            x.copy_(torch.randint(max(info.min, -128), min(info.max, 127) + 1,
                                  x.shape, generator=gen, dtype=torch.int64))
        return x
    for key in ("scan", "tail"):
        for node in cache.get(key, []):
            for x in node:
                fill(x)
    return cache


def block_op_scenarios(dist, dev):
    """The device halves of copy-on-write and of a swap on this rank's
    placed arenas (kv16 / kv8 / kv4 paged caches of random bytes, every
    field), against the same op on the whole cache, placed afterwards:
    ``cache_copy_block`` (block 2 into 5), ``cache_gather_blocks`` (blocks
    [6, 1, 3]) with the payload's bytes, ``cache_scatter_blocks`` of that
    payload into blocks [0, 4, 7]; and the whole-cells read of the copy
    (``attention._whole_cells``, the chunk step's read of a prefix-hit
    block in the sequence layout). {kv bits: results as numpy}."""
    from repro_torch.models.attention import _whole_cells
    cfg = get_config("gemma2-2b").reduced()

    def leaves(tree):
        return {p: x.cpu().numpy().copy()
                for p, x in tree_leaves_with_path(tree)}
    got = {}
    for kv_bits in (16, 8, 4):
        whole = _random_paged(cfg, kv_bits, dev, seed=kv_bits)
        placed = place_cache(tfm.clone_cache(whole), dist)
        r = {}
        tfm.cache_copy_block(whole, 2, 5)
        tfm.cache_copy_block(placed, torch.tensor(2), torch.tensor(5))
        r["copy"] = (leaves(placed), leaves(place_cache(whole, dist)))
        if dist.kv_seq_shard:       # layer 0's arena, as a layer reads it
            r["whole_cells"] = (
                leaves(_whole_cells(tfm._layer(placed["scan"][0], 0), dist)),
                leaves(tfm._layer(whole["scan"][0], 0)))
        ids = torch.tensor([6, 1, 3])
        pay = tfm.cache_gather_blocks(placed, ids)
        pay_whole = tfm.cache_gather_blocks(whole, ids)
        r["gather"] = (leaves(pay), leaves(place_cache(pay_whole, dist)),
                       leaves(pay_whole))
        new = torch.tensor([0, 4, 7])
        tfm.cache_scatter_blocks(placed, new, pay)
        tfm.cache_scatter_blocks(whole, new, pay_whole)
        r["scatter"] = (leaves(placed), leaves(place_cache(whole, dist)))
        got[kv_bits] = r
    return got


def weight_grid_scenarios(dist, dev):
    """``range_estimation.estimate_weight_params(split=)`` on this rank's
    slice of a (12, 10) weight, and the gradient of sum(fake_quant(w) * r)
    through it, for min-max and MSE, per-tensor and per-channel (axis -1),
    the weight cut on dim 0 and on dim 1. {case: (scale, zero-point,
    gradient of the rank's slice)} as numpy."""
    from repro_torch.core.quant_config import (Granularity,
                                               QuantizerConfig,
                                               RangeEstimator)
    from repro_torch.core.quantizer import fake_quant
    from repro_torch.core.range_estimation import estimate_weight_params
    gen = torch.Generator().manual_seed(11)
    w_all = torch.randn(12, 10, generator=gen)
    r_all = torch.randn(12, 10, generator=gen)
    n, i = coll.tp_size(dist), coll.tp_index(dist)
    got = {}
    for est in ("minmax", "mse"):
        for gran in ("tensor", "channel"):
            for dim in (0, 1):
                qcfg = QuantizerConfig(
                    bits=8, symmetric=True,
                    granularity=(Granularity.PER_TENSOR if gran == "tensor"
                                 else Granularity.PER_CHANNEL),
                    estimator=(RangeEstimator.CURRENT_MINMAX
                               if est == "minmax" else RangeEstimator.MSE))
                size = w_all.shape[dim] // n
                w = w_all.narrow(dim, i * size, size).clone() \
                    .requires_grad_(True)
                rr = r_all.narrow(dim, i * size, size)
                with torch.enable_grad():
                    qp = estimate_weight_params(w, qcfg, split=(dist, dim))
                    loss = torch.sum(fake_quant(w, qp, qcfg) * rr)
                    g, = torch.autograd.grad(loss, [w])
                got[est, gran, dim] = tuple(
                    t.detach().cpu().numpy().copy()
                    for t in (qp.scale, qp.zero_point, g))
    return got
