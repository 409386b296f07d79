"""Rank bodies of ``tests/test_torch_parallel.py`` (the KV-head cache
layout) and ``tests/test_torch_kvseq.py`` (the sequence layout, the
default): functions that ``repro_torch.launch.mesh.run_ranks`` spawns on a
CPU gloo group. No JAX here (every rank would import it): the tests hand
the reference's params and calibration across as numpy trees."""
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
    path) and the whole bytes of each."""
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
