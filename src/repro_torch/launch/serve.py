"""Serving launcher (port of ``repro.launch.serve``): batched requests
against any ``--arch`` of the registry, optionally W8A8-quantized —
prefill + decode with a KV cache, static or continuous scheduler. The
recurrent families (recurrentgemma-2b, rwkv6-1p6b) serve through the
static scheduler on dense caches only: their state has no per-lane
validity (``--scheduler continuous`` stops in ``cache_reset_slots``) and no
block layout (``--paged-kv`` stops in ``init_cache``), as in the
reference. An encoder-decoder config (seamless-m4t-medium) runs the
startup checks on the decoder-only view the launcher builds, then stops
with a ``SystemExit`` before serving: the serve loop's decode step is the
encoder-decoder one, which that view cannot feed (the reference stops at
the same point with ``KeyError: 'dec_pos'``).

``--quantize`` calibrates W8A8 PTQ with the paper's PEG recipe
(``peg_policy(4)``) and serves simulated quantization (fake-quant);
``--quantize --deploy-int8`` serves the integer path: weights pre-packed to
int8 and the attention / FFN projections on the hand-written kernels
(``rms_quantize -> int8_matmul_peg (fused epilogue) -> int8_matmul``), with
a parity check against the fake-quant reference printed at startup.
``--kv-bits 8`` stores the KV cache in int8 and decodes through the int8
attention kernels (``[kv-int8]`` check at startup); ``--kv-bits 4`` in
nibble-packed int4 through their 4-bit variants (``[kv-int4]`` check and
an int4-vs-int8 drift line; ``--parity`` then reports greedy-token match
rates instead of asserting equality, and serves the requests once more at
kv-bits 8). ``--weight-bits 4`` packs the deployable weights as int4
(symmetric, MSE ranges, two rows per byte) for the 4-bit matmul variants;
``--paged-kv`` pages
the cache in blocks (``--block-size``, ``--num-blocks``); ``--scheduler
continuous`` admits into freed lanes mid-flight, ``--prefill-chunk N`` in
chunks of N prompt tokens; ``--prefix-cache`` (continuous, paged) shares
the cached blocks of retired prompts through a radix cache, with
copy-on-write, on a workload whose prompts open with the same
``prompt_len // 2`` tokens. ``--over-commit`` (continuous, paged) drops
the worst-case block reservations: admission claims what the first chunk
needs, the queue goes by priority tier (``--priority N`` puts every other
request in tier N) and a pool that runs dry preempts a lane, whose blocks
go to host memory and back with ``--swap-blocks`` or are recomputed
through the chunk step without it; ``--decode-ratio N`` runs N decode
steps per chunk step. ``--parity`` serves the requests again under the
other scheduler, unchunked, dense, (with ``--prefix-cache``) unshared and
(with ``--over-commit``) with worst-case reservations, and checks the
greedy tokens are the same.

Telemetry (continuous scheduler): ``--trace FILE`` records the request
lifecycle and writes it as Chrome-trace JSON, with per-phase step-latency
percentiles; ``--metrics-every N`` snapshots the scheduler's gauges every
N steps (``FILE.metrics.jsonl`` beside the trace, Prometheus text at the
end); ``--quant-telemetry`` (needs ``--quantize``) serves through armed
steps and reports each quantization site's clip fraction and observed
amax against its calibrated range, and the KV cache's scales;
``--stats-json FILE`` writes the run's ``ServeStats``.

``--async`` (dense cache, FIFO; not with the paged, chunked, prefix,
over-commit or telemetry flags) streams the requests through
``runtime.async_serve.AsyncServer``: one scheduler thread drives the
engine's ``prefill`` / ``insert`` / ``generate``; ``--parity`` checks its
tokens against the static and the continuous scheduler.

Full width serves bf16 params on one GPU; ``--reduced`` serves the small
f32 config (``main(argv, dtype=torch.float32)`` serves either in f32).
Every other flag of the reference launcher is accepted by the parser and
rejected with "not yet ported" when set. The README quickstart:

    python -m repro_torch.launch.serve --arch gemma2-2b --reduced \
        --requests 6 --prompt-len 24 --new-tokens 6 --max-len 64 \
        --quantize --deploy-int8 --kv-bits 8 \
        --scheduler continuous --paged-kv --block-size 8 \
        --prefill-chunk 8 --parity

``main(argv, device="cpu")`` runs the plain PyTorch versions on the CPU.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import Mode, QuantCtx, build_deploy, peg_policy, ptq
from repro_torch.core.quant_config import QuantizerConfig, RangeEstimator
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.runtime import (BlockPool, RadixCache, Request,
                                 ServeTelemetry, blocks_for_tokens,
                                 make_admit_step, make_chunk_prefill_step,
                                 make_decode_step, make_prefill_step,
                                 make_swap_steps, serve)
from repro_torch.runtime.serve_loop import _check_capacity, _tree_bytes

# flags (by dest) the port serves; any other flag must keep its default
_PORTED = {"arch", "reduced", "requests", "prompt_len", "new_tokens",
           "batch_slots", "max_len", "skew", "seed", "quantize",
           "deploy_int8", "scheduler", "kv_bits", "weight_bits", "parity",
           "paged_kv", "block_size", "num_blocks", "prefill_chunk",
           "prefix_cache", "over_commit", "swap_blocks", "priority",
           "decode_ratio", "trace", "metrics_every", "quant_telemetry",
           "stats_json", "async_serve", "tp"}


def build_parser() -> argparse.ArgumentParser:
    """The serve CLI: a copy of the reference's flag set, so the two
    launchers accept the same command lines. Flags outside the ported
    slice are rejected in :func:`main`."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--scheduler", choices=("static", "continuous"),
                    default="static",
                    help="static: group batching, lockstep decode per "
                         "group; continuous: slot-scheduled decode with "
                         "in-flight admission into freed lanes")
    ap.add_argument("--parity", action="store_true",
                    help="serve the same requests under BOTH schedulers "
                         "and verify identical per-request greedy tokens")
    ap.add_argument("--skew", type=int, default=0, metavar="N",
                    help="give every other request max_new_tokens=N "
                         "(skewed-quota workload; shows the continuous "
                         "scheduler's utilization win)")
    ap.add_argument("--quantize", action="store_true",
                    help="W8A8 PTQ (PEG on the FFN path) before serving")
    ap.add_argument("--deploy-int8", action="store_true",
                    help="serve the integer path: packed int8 weights + "
                         "Pallas kernels (requires --quantize)")
    ap.add_argument("--kv-bits", type=int, default=16, choices=(4, 8, 16),
                    help="8: int8 KV cache + fused int8 decode attention; "
                         "4: nibble-packed int4 cache (half the int8 HBM), "
                         "decoded through the kernels' in-VMEM unpack path "
                         "(both require --deploy-int8); 16: bf16/f32 cache")
    ap.add_argument("--weight-bits", type=int, default=8, choices=(4, 8),
                    help="4: pack deployable weights as int4 (two rows per "
                         "byte, MSE ranges; kernels unpack in VMEM — "
                         "halves HBM weight reads; requires --quantize); "
                         "8: standard W8A8 packing")
    ap.add_argument("--paged-kv", action="store_true",
                    help="block-paged KV cache: continuous scheduling "
                         "allocates blocks per LIVE token (block pool + "
                         "per-lane block tables); static serves through a "
                         "fully mapped identity table")
    ap.add_argument("--block-size", type=int, default=16, metavar="N",
                    help="token cells per KV block (with --paged-kv)")
    ap.add_argument("--num-blocks", type=int, default=0, metavar="N",
                    help="physical blocks in the paged pool (0 = dense "
                         "worst case batch_slots x ceil(max_len/bs); "
                         "smaller values exercise admission backpressure; "
                         "continuous scheduler only)")
    ap.add_argument("--prefill-chunk", type=int, default=0, metavar="N",
                    help="admit prompts in chunks of at most N tokens "
                         "interleaved with resident decode steps (chunked "
                         "prefill; 0 = monolithic slot-insert prefill; "
                         "continuous scheduler only)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix prefix cache over retired prompt blocks: "
                         "admission maps the longest block-aligned cached "
                         "prefix read-only (refcounted, copy-on-write) and "
                         "prefills only the novel suffix; synthesizes a "
                         "shared-prefix workload (continuous + --paged-kv)")
    ap.add_argument("--over-commit", action="store_true",
                    help="drop worst-case block reservations: admit "
                         "against actual prefix + first-chunk need, grow "
                         "on demand, and preempt a victim lane (lowest "
                         "priority, then youngest) when the pool runs dry "
                         "(continuous + --paged-kv)")
    ap.add_argument("--swap-blocks", action="store_true",
                    help="preempt by spilling the victim's blocks to a "
                         "host-memory buffer and re-uploading on resume "
                         "(bit-exact) instead of dropping + re-prefilling "
                         "them (requires --over-commit)")
    ap.add_argument("--priority", type=int, default=0, metavar="N",
                    help="give every other request priority tier N "
                         "(mirrors --skew; the over-commit scheduler "
                         "admits high tiers first and preempts low tiers "
                         "first; 0 = all requests tier 0)")
    ap.add_argument("--decode-ratio", type=int, default=1, metavar="N",
                    help="decode steps per chunk-prefill step once lanes "
                         "are decodable (>1 holds decode cadence under "
                         "prefill pressure; needs a chunked path: "
                         "--prefill-chunk or --over-commit)")
    ap.add_argument("--trace", metavar="FILE", default="",
                    help="record request-lifecycle events and write a "
                         "Chrome-trace-event JSON (load in "
                         "https://ui.perfetto.dev) to FILE; also prints "
                         "per-phase step-latency p50/p95/p99 (continuous "
                         "scheduler only)")
    ap.add_argument("--metrics-every", type=int, default=0, metavar="N",
                    help="snapshot scheduler gauges (queue depth, resident "
                         "lanes, pool blocks, prefix hit rate, preemptions) "
                         "every N steps; written as JSON-lines next to "
                         "--trace (FILE.metrics.jsonl) and printed as "
                         "Prometheus text at exit (continuous only)")
    ap.add_argument("--quant-telemetry", action="store_true",
                    help="thread fixed-shape clip/saturation reductions out "
                         "of the jitted steps and report per-site clip "
                         "fractions + observed-amax/calibrated-range ratios "
                         "(and kv-cache scale stats at --kv-bits 8/4); "
                         "requires --quantize, continuous scheduler only")
    ap.add_argument("--stats-json", metavar="FILE", default="",
                    help="write the primary run's ServeStats as JSON to "
                         "FILE (ServeStats.to_json)")
    ap.add_argument("--async", dest="async_serve", action="store_true",
                    help="serve through the async front-end: requests "
                         "submit into a thread-safe queue and stream "
                         "tokens back per request while ONE scheduler "
                         "thread drives the engine's decomposed "
                         "prefill/insert/generate triad "
                         "(runtime.async_serve; dense cache only — "
                         "incompatible with --paged-kv/--prefill-chunk/"
                         "--prefix-cache/--over-commit and the telemetry "
                         "flags)")
    ap.add_argument("--tp", type=int, default=1, metavar="N",
                    help="serve tensor-parallel on N ranks (a (1, N) mesh "
                         "over (data, model), torch.distributed): every "
                         "rank runs the same host loop on the same "
                         "requests over its slice of the params and "
                         "caches; all ranks on one GPU (gloo), one GPU "
                         "each when there are N (nccl), or the CPU with "
                         "main(..., device='cpu') (requires --reduced; "
                         "1 = unsharded)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def _reject_unported(ap: argparse.ArgumentParser, args,
                     ported=_PORTED) -> None:
    """Stop with "... is not yet ported" on a flag outside ``ported`` that
    was given a value other than its default."""
    for action in ap._actions:
        dest = action.dest
        if dest == "help" or not action.option_strings:
            continue
        value = getattr(args, dest)
        if dest not in ported and value != ap.get_default(dest):
            ap.error(f"{action.option_strings[0]} is not yet ported")


def _fallback_note(cfg, packed, qm) -> str:
    """Which blocks serve on the integer kernels, and why the others fall
    back to fake-quant. Stacked blocks count once per repeat, tail blocks
    once; an MoE block has no ``"ffn"``: its experts stay on the fake-quant
    path (batched matmuls), as the reference leaves them."""
    from repro_torch.core import deploy
    from repro_torch.models.ffn import is_packed
    blocks = ([(b, cfg.n_super) for b in packed["scan"]]
              + [(b, 1) for b in packed["tail"]])

    def ffn_packed(b):
        return is_packed(b["ffn"])
    n_attn = sum(n for b, n in blocks
                 if deploy.is_packed(b.get("attn", {}).get("wq")))
    n_ffn = sum(n for b, n in blocks if "ffn" in b and ffn_packed(b))
    note = (f"[deploy-int8] integer kernels: attention projections in "
            f"{n_attn}/{cfg.num_layers} layers, FFN in "
            f"{n_ffn}/{cfg.num_layers} layers")
    n_moe = sum(n for b, n in blocks if "moe" in b)
    n_rwkv = sum(n for b, n in blocks if "tmix" in b)
    body_ffn = [ffn_packed(b) for b in packed["scan"] if "ffn" in b]
    tail_ffn = [ffn_packed(b) for b in packed["tail"] if "ffn" in b]
    if n_moe:
        note += (f"; fake-quant fallback: MoE experts in {n_moe} layers "
                 f"(not packed, as in the reference)")
    elif n_rwkv:
        note += (f"; fake-quant fallback: RWKV time-mix and channel-mix in "
                 f"{n_rwkv} layers (not packed, as in the reference)")
    elif not all(body_ffn):
        spec = qm.peg_specs.get("layer0/ffn_in")
        why = ("" if spec is None else
               f" (ffn_in PEG groups {spec.group_sizes.tolist()} are not "
               f"uniform)")
        note += f"; fake-quant fallback: layer/ffn{why}"
    elif not all(tail_ffn):
        # the serving act state shares layer 0's calibration under
        # "layer/..." names; the tail's "tail/..." sites have none, in the
        # reference too
        note += ("; fake-quant fallback: tail/ffn (no calibrated tail/ffn_in "
                 "site, as in the reference)")
    n8, n4, nbytes = deploy.packed_summary(packed)
    return (f"{note}\n[deploy-int8] packed weights: {n8} int8 and {n4} "
            f"int4 (q4) payloads, {nbytes / 2**20:.1f} MiB")


def _check_args(ap: argparse.ArgumentParser, args) -> None:
    if args.deploy_int8 and not args.quantize:
        ap.error("--deploy-int8 requires --quantize")
    if args.kv_bits < 16 and not args.deploy_int8:
        ap.error(f"--kv-bits {args.kv_bits} requires --deploy-int8 (the "
                 "quantized KV cache is a deploy-path feature)")
    if args.block_size < 1:
        ap.error("--block-size must be >= 1")
    if args.prefill_chunk < 0:
        ap.error("--prefill-chunk must be >= 0")
    if args.prefill_chunk and args.scheduler != "continuous":
        ap.error("--prefill-chunk requires --scheduler continuous (static "
                 "groups prefill monolithically)")
    if args.num_blocks and not args.paged_kv:
        ap.error("--num-blocks requires --paged-kv")
    if args.prefix_cache and not args.paged_kv:
        ap.error("--prefix-cache requires --paged-kv (prefix sharing maps "
                 "cached blocks through the block pool)")
    if args.prefix_cache and args.scheduler != "continuous":
        ap.error("--prefix-cache requires --scheduler continuous (the "
                 "static scheduler has no pool to share blocks from)")
    if args.over_commit and not (args.paged_kv
                                 and args.scheduler == "continuous"):
        ap.error("--over-commit requires --paged-kv and --scheduler "
                 "continuous (preemption is a paged feature)")
    if args.swap_blocks and not args.over_commit:
        ap.error("--swap-blocks requires --over-commit")
    if args.decode_ratio < 1:
        ap.error("--decode-ratio must be >= 1")
    if args.decode_ratio > 1 and not (args.prefill_chunk
                                      or args.over_commit):
        ap.error("--decode-ratio > 1 requires a chunked path "
                 "(--prefill-chunk or --over-commit)")
    if args.metrics_every < 0:
        ap.error("--metrics-every must be >= 0")
    if (args.trace or args.metrics_every or args.quant_telemetry) \
            and args.scheduler != "continuous":
        ap.error("--trace/--metrics-every/--quant-telemetry require "
                 "--scheduler continuous (telemetry instruments the "
                 "continuous scheduler's request lifecycle)")
    if args.quant_telemetry and not args.quantize:
        ap.error("--quant-telemetry requires --quantize (clip fractions "
                 "are measured against the calibrated quantization grids)")
    if args.async_serve and (args.paged_kv or args.prefill_chunk
                             or args.prefix_cache or args.over_commit
                             or args.trace or args.metrics_every
                             or args.quant_telemetry or args.stats_json):
        ap.error("--async serves through the bare engine triad (dense "
                 "cache, FIFO admission) — incompatible with --paged-kv/"
                 "--prefill-chunk/--prefix-cache/--over-commit and the "
                 "telemetry/--stats-json flags")
    if args.tp < 1:
        ap.error("--tp must be >= 1")
    if args.tp > 1 and not args.reduced:
        ap.error("--tp is the host-simulated tensor-parallel mode "
                 "(--reduced); the full-size path builds its own "
                 "production mesh")
    if args.multi_pod:
        ap.error("--multi-pod is not yet ported under --tp / dist (it "
                 "builds the production mesh of 512 chips)")
    _reject_unported(ap, args)


def _quantize(cfg, args, params, dtype, dev):
    """W8A8 PTQ (and with --deploy-int8 the packed integer params, their
    parity lines and the [kv-int8] check). Returns (params, ctx_factory)."""
    # calibrate on a few synthetic prompts with the unrolled layout, then
    # serve with layer-shared quant params (layer 0's win)
    pol = peg_policy(4)
    if args.weight_bits == 4:
        # sub-8-bit weights (paper Tables 5-7): symmetric int4 grid, MSE
        # ranges; activations stay on the W8A8 / PEG policy
        pol = dataclasses.replace(pol, weight_default=QuantizerConfig(
            bits=4, symmetric=True, estimator=RangeEstimator.MSE))
    flat = tfm.init_params(cfg, args.seed, stacked=False, dtype=dtype,
                           device=dev)
    rng = np.random.RandomState(10)
    calib = [{"tokens": torch.as_tensor(
        rng.randint(0, cfg.vocab_size, (2, args.prompt_len)),
        device=dev)} for _ in range(2)]

    def fwd(p, b, ctx):
        return tfm.forward(cfg, p, b["tokens"], ctx=ctx)[0]
    qm = ptq(fwd, flat, calib, pol, collect_inputs=args.deploy_int8)
    del flat
    shared = {}
    for site, qp in qm.act_state.items():
        base = "layer/" + site.split("/", 1)[1] \
            if site.startswith("layer") else site
        shared.setdefault(base, qp)
    state = dict(shared)
    # one memo of fake-quantized weights for every ctx of this session
    weight_cache = {}
    if not args.deploy_int8:
        def apply_ctx():
            return QuantCtx(policy=pol, mode=Mode.APPLY, act_state=state,
                            weight_cache=weight_cache)
        return params, apply_ctx

    fp_params = params
    params, deploy_acts = build_deploy(cfg, params, pol, state)

    def ctx_factory():
        return QuantCtx(policy=pol, mode=Mode.DEPLOY, act_state=state,
                        deploy_acts=deploy_acts, weight_cache=weight_cache)

    # parity: integer path vs the fake-quant reference it replaces
    toks = torch.as_tensor(np.random.RandomState(99).randint(
        0, cfg.vocab_size, (2, args.prompt_len)), device=dev)
    ref_ctx = QuantCtx(policy=pol, mode=Mode.APPLY, act_state=state,
                       weight_cache=weight_cache)
    with torch.no_grad():
        logits_ref, _ = tfm.forward(cfg, fp_params, toks, ctx=ref_ctx)
        logits_int, _ = tfm.forward(cfg, params, toks, ctx=ctx_factory())
    diff = float((logits_ref.float() - logits_int.float()).abs().max())
    scale = float(logits_ref.float().abs().max()) + 1e-9
    print(f"[deploy-int8] max |fake-quant - int8| logits diff "
          f"{diff:.5f} (rel {diff / scale:.4%})")
    print(_fallback_note(cfg, params, qm))
    if args.kv_bits in (4, 8):
        print(_kv_quant_check(cfg, args, params, ctx_factory, toks, dtype,
                              dev))
    if args.kv_bits == 4:
        print(_kv_int4_drift(cfg, args, params, ctx_factory, toks, dtype,
                             dev))
    return params, ctx_factory


def _report_telemetry(args, telemetry: ServeTelemetry,
                      write: bool = True) -> None:
    """The reference launcher's telemetry lines: the trace's event and
    retired-request counts and per-phase step latencies (host time), the
    metrics snapshots and Prometheus text, and the quant-health report
    (the ten sites that clip most, the KV cache's scales). The trace and
    metrics files are written only with ``write`` (rank 0 of ``--tp``)."""
    if telemetry.tracer is not None:
        if write:
            telemetry.tracer.dump(args.trace)
        spans = telemetry.tracer.request_spans()
        retired = sum(1 for s in spans.values() if s["retired"])
        print(f"[trace] {len(telemetry.tracer.events)} events, "
              f"{retired}/{len(spans)} requests retired -> {args.trace}")
        for ph, h in sorted(telemetry.tracer.latency_histograms().items()):
            print(f"[trace] {ph}: n={h['n']} p50 {h['p50']:.2f}ms "
                  f"p95 {h['p95']:.2f}ms p99 {h['p99']:.2f}ms")
    if telemetry.metrics is not None:
        if args.trace:
            mpath = args.trace + ".metrics.jsonl"
            if write:
                with open(mpath, "w") as f:
                    f.write(telemetry.metrics.jsonl())
            print(f"[metrics] {len(telemetry.metrics.snapshots)} "
                  f"snapshots -> {mpath}")
        print(telemetry.metrics.prometheus_text(), end="")
    if telemetry.quant is not None:
        rep = telemetry.quant.report()
        sites = rep["sites"]
        print(f"[quant-health] {len(sites)} sites over "
              f"{rep['steps_observed']} telemetry steps")
        ranked = sorted(sites.items(), key=lambda kv: -kv[1]["clip_fraction"])
        for s, d in ranked[:10]:
            print(f"[quant-health] {s}: clip {d['clip_fraction']:.4%} "
                  f"({d['clipped']}/{d['total']}), amax "
                  f"{d['observed_amax']:.4f} / range "
                  f"{d['calibrated_range']:.4f} "
                  f"(ratio {d['amax_ratio']:.2f})")
        for name, st in sorted(rep["kv_scales"].items()):
            print(f"[quant-health] {name}: n={st['n']} "
                  f"min {st['min']:.3e} p50 {st['p50']:.3e} "
                  f"p99 {st['p99']:.3e} max {st['max']:.3e}")


@torch.no_grad()
def _kv_quant_check(cfg, args, params, ctx_factory, toks, dtype,
                    dev) -> str:
    """Multi-step decode parity of the int8 / int4 KV cache (decode through
    K5) against the f32/bf16-cache integer path, teacher-forced on the
    latter's argmax."""
    B, steps = toks.shape[0], 4
    c16 = tfm.init_cache(cfg, B, args.max_len, dtype=dtype, device=dev)
    cq = tfm.init_cache(cfg, B, args.max_len, dtype=dtype,
                        kv_bits=args.kv_bits, device=dev)
    l16, c16 = tfm.prefill(cfg, params, toks, c16, ctx=ctx_factory())
    lq, cq = tfm.prefill(cfg, params, toks, cq, ctx=ctx_factory())

    def rel(a, b):
        a, b = a.float(), b.float()
        return float((a - b).abs().max() / (a.abs().max() + 1e-9))
    worst = rel(l16, lq)
    cur = torch.argmax(l16, dim=-1).to(torch.int32)
    pos = torch.full((B, 1), toks.shape[1], dtype=torch.int32, device=dev)
    for _ in range(steps):
        l16, c16 = tfm.decode_step(cfg, params, cur, pos, c16,
                                   ctx=ctx_factory())
        lq, cq = tfm.decode_step(cfg, params, cur, pos, cq,
                                 ctx=ctx_factory())
        worst = max(worst, rel(l16, lq))
        cur = torch.argmax(l16, dim=-1).to(torch.int32)
        pos = pos + 1
    return (f"[kv-int{args.kv_bits}] max rel logits diff over prefill + "
            f"{steps} decode steps vs bf16 cache: {worst:.4%}")


@torch.no_grad()
def _kv_int4_drift(cfg, args, params, ctx_factory, toks, dtype, dev) -> str:
    """int4 vs int8 cache drift: the max-abs logit delta and the greedy-token
    match rate over prefill + 4 decode steps, teacher-forced on the int8
    path's argmax so both see the same inputs."""
    B, steps = toks.shape[0], 4
    c8, c4 = (tfm.init_cache(cfg, B, args.max_len, dtype=dtype, kv_bits=b,
                             device=dev) for b in (8, 4))
    l8, c8 = tfm.prefill(cfg, params, toks, c8, ctx=ctx_factory())
    l4, c4 = tfm.prefill(cfg, params, toks, c4, ctx=ctx_factory())

    def compare(l8, l4):
        delta = float((l8.float() - l4.float()).abs().max())
        same = int((torch.argmax(l4, dim=-1) ==
                    torch.argmax(l8, dim=-1)).sum())
        return delta, same
    delta, matched = compare(l8, l4)
    total = B
    cur = torch.argmax(l8, dim=-1).to(torch.int32)
    pos = torch.full((B, 1), toks.shape[1], dtype=torch.int32, device=dev)
    for _ in range(steps):
        l8, c8 = tfm.decode_step(cfg, params, cur, pos, c8,
                                 ctx=ctx_factory())
        l4, c4 = tfm.decode_step(cfg, params, cur, pos, c4,
                                 ctx=ctx_factory())
        d, m = compare(l8, l4)
        delta, matched, total = max(delta, d), matched + m, total + B
        cur = torch.argmax(l8, dim=-1).to(torch.int32)
        pos = pos + 1
    return (f"[kv-int4] int4 vs int8 cache drift over prefill + {steps} "
            f"decode steps: max |logit delta| {delta:.5f}, greedy-token "
            f"match {matched}/{total} ({matched / total:.1%})")


def _serve_async(args, cfg, params, ctx_factory, dtype, dev, requests,
                 make_requests, run, dist=None, info=None) -> None:
    """``--async``: stream ``requests`` through an :class:`AsyncServer` over
    an engine from ``make_engine`` (dense cache), print the reference
    launcher's ``[serve:async]`` line with the engine's step-signature
    counts and, with ``--parity``, the greedy tokens against the static
    and the continuous scheduler (match rates at kv-bits 4)."""
    from repro_torch.runtime import AsyncServer, make_engine
    eng = make_engine(cfg, params, batch_slots=args.batch_slots,
                      prompt_pad_len=args.prompt_len, max_len=args.max_len,
                      dtype=dtype, kv_bits=args.kv_bits,
                      ctx_factory=ctx_factory, device=dev, dist=dist)
    t0 = time.perf_counter()
    with AsyncServer(eng) as srv:
        streams = [srv.submit(r.prompt, r.max_new_tokens, rid=r.rid)
                   for r in requests]
        for r, s in zip(requests, streams):
            r.tokens_out = s.result(timeout=600)
            r.done = True
    wall = time.perf_counter() - t0
    if info is not None:
        info["tokens"] = [list(r.tokens_out) for r in requests]
    total = sum(len(r.tokens_out) for r in requests)
    print(f"[serve:async] {total} tokens from {len(requests)} streamed "
          f"requests, {wall:.2f}s ({total / max(wall, 1e-9):.1f} tok/s), "
          f"engine step signatures {eng.signature_counts} ({dev.type})"
          + (f", tp={args.tp} over {args.tp} ranks" if dist else ""))
    if not args.parity:
        return
    for sched in ("static", "continuous"):
        sync_reqs = make_requests()
        run(sched, sync_reqs)
        pairs = list(zip(requests, sync_reqs))
        if args.kv_bits == 4:
            matched = sum(1 for r, b in pairs
                          for x, y in zip(r.tokens_out, b.tokens_out)
                          if x == y)
            tot = sum(min(len(r.tokens_out), len(b.tokens_out))
                      for r, b in pairs)
            print(f"[parity] async engine vs {sched} scheduler: "
                  f"{matched}/{tot} greedy tokens match "
                  f"({matched / max(tot, 1):.1%}) — int4 drift reported, "
                  f"not asserted")
            continue
        bad = [r.rid for r, b in pairs
               if list(r.tokens_out) != list(b.tokens_out)]
        if bad:
            raise SystemExit(
                f"[parity] FAIL: request ids {bad} diverge between the "
                f"async engine and the {sched} scheduler")
        print(f"[parity] OK: async engine and {sched} scheduler emit "
              f"identical greedy tokens for all {len(requests)} requests")


def _serve_rank(dist, dev, argv, dtype):
    """One rank of :func:`serve_tp`: serve ``argv`` on this rank's slice.
    Returns (rank 0's output, rank 0's result, this rank's report)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.parallel import collectives as coll
    rank = dist.mesh.rank
    ap = build_parser()
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    kops.reset_launch_counts()
    coll.seconds = 0.0
    coll.calls.clear()
    info = {"rank": rank, "device": str(dev), "backend": dist.mesh.backend}
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out if rank == 0 else io.StringIO()):
        ret = _serve_main(ap, args, cfg, dev, dtype, dist, info)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    info.update(seconds=time.perf_counter() - t0, collective_s=coll.seconds,
                collective_calls=dict(coll.calls),
                launches=kops.launch_counts())
    return out.getvalue(), (ret if rank == 0 else None), info


def serve_tp(argv, world: int, *, device=None, dtype=None, report=None):
    """Serve ``argv`` on ``world`` tensor-parallel ranks
    (``launch.mesh.run_ranks``: spawned processes, one (1, world) mesh,
    ``cuda:0`` for every rank on a one-card host, ``cuda:rank`` with a card
    each, or the CPU), each running the serve body with its
    ``DistContext``. Rank 0's output is printed here and its result
    returned; ``report``, a list, receives every rank's report. A failing
    rank ends the run (``run_ranks``)."""
    from repro_torch.launch.mesh import run_ranks
    ranks = run_ranks(_serve_rank, world, (argv, dtype), device=device)
    print(ranks[0][0], end="")
    if report is not None:
        report.extend(info for _, _, info in ranks)
    return ranks[0][1]


def main(argv=None, *, device=None, dtype=None, report=None):
    """Parse ``argv`` and serve. ``dtype`` overrides the params' dtype
    (bf16 at full width, f32 with ``--reduced``). Returns the run's
    ``ServeStats``, or with ``--async`` the served requests. ``report``, a
    list, receives one dict per process that served (the primary run's
    greedy tokens by request, its ``ServeStats`` and ``ServeTelemetry``,
    None without the telemetry flags; under ``--tp`` also each rank's
    device, kernel launches, host seconds and calls by kind of the
    collectives and resident parameter bytes against the whole).

    ``--tp N`` serves on N ranks (:func:`serve_tp`): this process spawns
    them and returns rank 0's result."""
    ap = build_parser()
    args = ap.parse_args(argv)
    _check_args(ap, args)
    try:
        cfg = get_config(args.arch)
    except KeyError as e:
        ap.error(str(e))
    if args.reduced:
        cfg = cfg.reduced()
    if args.tp > 1:
        from repro_torch.launch.mesh import AbstractMesh
        from repro_torch.parallel.sharding import (make_seq_cache_specs,
                                                   serving_dist)
        dist = serving_dist(AbstractMesh((1, args.tp), ("data", "model")))
        try:
            tfm.check_tp(cfg, dist)
            # the caches' cells on the ranks, on shapes only (meta tensors)
            for paged in {False, args.paged_kv}:
                make_seq_cache_specs(tfm.init_cache(
                    cfg, args.batch_slots, args.max_len, kv_bits=args.kv_bits,
                    paged=paged, block_size=args.block_size, device="meta"),
                    dist)
        except NotImplementedError as e:
            ap.error(str(e))
        _plan(ap, args, cfg)
        return serve_tp(list(argv if argv is not None else sys.argv[1:]),
                        args.tp, device=device, dtype=dtype, report=report)
    info = None if report is None else {"rank": 0}
    ret = _serve_main(ap, args, cfg, resolve_device(device), dtype,
                      info=info)
    if report is not None:
        report.append(info)
    return ret


def _plan(ap: argparse.ArgumentParser, args, cfg):
    """(per-lane table width, ring tokens, pool blocks), after the checks
    that stop a workload the serve loop would reject before the model is
    built."""
    nb_lane = (tfm.paged_lane_blocks(cfg, args.max_len, args.block_size)
               if args.paged_kv
               else blocks_for_tokens(args.max_len, args.block_size))
    ring_tokens = (tfm.paged_ring_tokens(cfg, args.max_len, args.block_size)
                   if args.paged_kv else None)
    full_blocks = args.batch_slots * nb_lane
    num_blocks = args.num_blocks or full_blocks
    if args.paged_kv and args.scheduler == "static" \
            and num_blocks < full_blocks:
        ap.error("static paged serving needs the dense worst case "
                 f"(--num-blocks >= {full_blocks}); pool-constrained "
                 "admission is a continuous-scheduler feature")
    # the same check serve() runs on the real requests
    probe_pool = BlockPool(num_blocks, args.block_size, args.batch_slots,
                           nb_lane) if args.paged_kv else None
    try:
        _check_capacity([Request(rid=-1,
                                 prompt=np.zeros(args.prompt_len, np.int32),
                                 max_new_tokens=max(args.new_tokens,
                                                    args.skew))],
                        args.max_len, probe_pool, ring_tokens)
    except ValueError as e:
        ap.error(f"--max-len / --num-blocks too small: {e}")
    return nb_lane, ring_tokens, num_blocks


def _serve_main(ap, args, cfg, dev, dtype, dist=None, info=None):
    """The serve body (one process, or one rank of ``--tp`` with ``dist``:
    the startup checks run on the whole params, which are then placed on
    this rank's slice and served tensor-parallel; every rank runs its
    tracer, metrics and quant-health report, and only rank 0 writes the
    trace, metrics and ``--stats-json`` files). ``info``, a dict, receives
    the rank's resident parameter bytes and the whole's."""
    if dev.type == "cuda":
        # f32 matmuls in full f32, as the reference computes them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if dtype is None:
        dtype = torch.float32 if args.reduced else torch.bfloat16
    nb_lane, ring_tokens, num_blocks = _plan(ap, args, cfg)

    params = tfm.init_params(cfg, args.seed, stacked=True, dtype=dtype,
                             device=dev)
    ctx_factory = None
    if args.quantize:
        params, ctx_factory = _quantize(cfg, args, params, dtype, dev)
    if cfg.encoder_layers:
        raise SystemExit(
            f"{cfg.name}: the serve loop's decode step is the encoder-decoder "
            f"one (encdec.decode_step over a DecoderCache), which this "
            f"launcher's decoder-only params and caches cannot feed (they "
            f"have no 'dec_pos'; the reference launcher stops here with "
            f"KeyError: 'dec_pos'). Serve encoder-decoder configs with "
            f"runtime.steps.make_encoder_forward and make_decode_step on "
            f"encdec.init_params.")

    whole, step_ctx = params, ctx_factory
    if dist is not None:
        # the startup checks ran on the whole params; the serving steps run
        # on this rank's slice, their fake-quant weights cut from the whole
        # weights' (the session memo of the whole ones is let go)
        from repro_torch.parallel.sharding import (make_param_shardings,
                                                   shard_ctx_factory)
        params = make_param_shardings(whole, dist)
        step_ctx = shard_ctx_factory(cfg, whole, params, ctx_factory, dist)
        if ctx_factory is not None and ctx_factory().weight_cache:
            ctx_factory().weight_cache.clear()
        if info is not None:
            info.update(param_bytes=_tree_bytes(params),
                        whole_param_bytes=_tree_bytes(whole))
        if not args.async_serve:
            whole = None

    kw = dict(ctx_factory=step_ctx, dist=dist)
    prefill = make_prefill_step(cfg, **kw)
    admit = make_admit_step(cfg, **kw)
    decode = make_decode_step(cfg, **kw)
    chunk_step = make_chunk_prefill_step(cfg, **kw)
    swap_out, swap_in = (make_swap_steps() if args.swap_blocks
                         else (None, None))
    telemetry = None
    if args.trace or args.metrics_every or args.quant_telemetry:
        telemetry = ServeTelemetry.create(trace=bool(args.trace),
                                          metrics_every=args.metrics_every,
                                          quant=args.quant_telemetry)
    # quant telemetry serves through separate armed closures: the plain
    # steps stay as they are for the untraced runs (the --parity reruns)
    admit_t = decode_t = chunk_t = None
    if args.quant_telemetry:
        admit_t = make_admit_step(cfg, **kw, quant_telemetry=True)
        decode_t = make_decode_step(cfg, **kw, quant_telemetry=True)
        chunk_t = make_chunk_prefill_step(cfg, **kw, quant_telemetry=True)
    writes = dist is None or dist.mesh.rank == 0

    def make_requests():
        # the reference launcher's draws: with --prefix-cache every prompt
        # opens with the same prompt_len // 2 tokens (a shared system
        # prompt), drawn first from the same generator
        rng = np.random.RandomState(args.seed)
        shared = (rng.randint(10, cfg.vocab_size, size=args.prompt_len // 2)
                  if args.prefix_cache else np.zeros(0, np.int64))
        return [Request(rid=i,
                        prompt=np.concatenate(
                            [shared,
                             rng.randint(10, cfg.vocab_size,
                                         size=args.prompt_len - len(shared))]
                        ).astype(np.int64),
                        max_new_tokens=(args.skew if args.skew and i % 2
                                        else args.new_tokens),
                        priority=(args.priority if args.priority and i % 2
                                  else 0))
                for i in range(args.requests)]

    def init_cache(batch, paged, scheduler, kv_bits):
        kw = dict(dtype=dtype, kv_bits=kv_bits, device=dev)
        if not paged:
            cache = tfm.init_cache(cfg, batch, args.max_len, **kw)
        elif scheduler == "static":
            # fully mapped identity table: the static loop has no pool
            cache = tfm.init_cache(cfg, batch, args.max_len, paged=True,
                                   block_size=args.block_size, **kw)
        else:
            cache = tfm.init_cache(cfg, batch, args.max_len, paged=True,
                                   block_size=args.block_size,
                                   num_blocks=num_blocks, mapped=False, **kw)
        if dist is not None:
            from repro_torch.parallel.sharding import place_cache
            cache = place_cache(cache, dist)
        return cache

    def run(scheduler, requests, paged=None, chunk=0, kv_bits=None,
            prefix=None, over_commit=None, tel=None):
        paged = args.paged_kv if paged is None else paged
        kv_bits = args.kv_bits if kv_bits is None else kv_bits
        prefix = ((args.prefix_cache if prefix is None else prefix)
                  and paged and scheduler == "continuous")
        oc = ((args.over_commit if over_commit is None else over_commit)
              and paged and scheduler == "continuous")
        pool = None
        if paged and scheduler == "continuous":
            pool = BlockPool(num_blocks, args.block_size, args.batch_slots,
                             nb_lane)
        armed = tel is not None and tel.quant is not None
        a_step, d_step, c_step = ((admit_t, decode_t, chunk_t) if armed
                                  else (admit, decode, chunk_step))
        return serve(prefill, d_step,
                     lambda b: init_cache(b, paged, scheduler, kv_bits),
                     params,
                     requests, scheduler=scheduler,
                     batch_slots=args.batch_slots, max_len=args.max_len,
                     admit_step=a_step,
                     chunk_step=(c_step if (chunk or prefix or oc)
                                 else None),
                     block_pool=pool, prefill_chunk=chunk or None,
                     ring_tokens=ring_tokens if pool else None,
                     radix_cache=(RadixCache(args.block_size) if prefix
                                  else None),
                     write_caps=(tfm.attn_write_caps(cfg, args.max_len,
                                                     args.block_size)
                                 if pool else None),
                     copy_block_fn=tfm.cache_copy_block if prefix else None,
                     over_commit=oc, swap_out_fn=swap_out if oc else None,
                     swap_in_fn=swap_in if oc else None,
                     decode_ratio=(args.decode_ratio
                                   if (chunk or prefix or oc) else 1),
                     telemetry=tel, device=dev, dist=dist)

    requests = make_requests()
    if args.async_serve:
        _serve_async(args, cfg, whole, ctx_factory, dtype, dev, requests,
                     make_requests, run, dist, info)
        return requests
    stats = run(args.scheduler, requests, chunk=args.prefill_chunk,
                tel=telemetry)
    if info is not None:
        info["tokens"] = [list(r.tokens_out) for r in requests]
        info["cache_bytes"] = stats.cache_bytes
        info.update(stats=stats, telemetry=telemetry)
    if args.paged_kv and args.scheduler == "continuous":
        paged_note = (f", blocks {stats.blocks_in_use}/{num_blocks} "
                      f"(frag {stats.block_fragmentation:.0%}, "
                      f"block-size {args.block_size})")
    elif args.paged_kv:
        paged_note = (f", paged identity-mapped (block-size "
                      f"{args.block_size})")
    else:
        paged_note = ""
    chunk_note = (f", chunked prefill ({stats.chunk_steps} chunk steps @ "
                  f"<= {args.prefill_chunk} tokens)"
                  if args.prefill_chunk else "")
    prefix_note = (f", prefix-cache hits {stats.prefix_hit_tokens} tokens "
                   f"(rate {stats.prefix_hit_rate:.0%}, "
                   f"{stats.prefill_tokens_saved} prefill tokens saved, "
                   f"peak {stats.shared_blocks} shared blocks)"
                   if args.prefix_cache else "")
    oc_note = (f", over-commit: {stats.preemptions} preemptions "
               f"({stats.swapped_blocks} blocks swapped, "
               f"{stats.recomputed_tokens} tokens recomputed), "
               f"queue-wait {stats.queue_wait_steps} steps"
               if args.over_commit else "")
    print(f"[serve:{args.scheduler}] {stats.tokens_generated} tokens, "
          f"{stats.decode_steps} decode steps, "
          f"{stats.prefill_calls} prefills, {stats.wall_s:.2f}s "
          f"({stats.tokens_per_s:.1f} tok/s), "
          f"slot-utilization {stats.slot_utilization:.0%}, "
          f"peak kv-cache {stats.cache_bytes / 1024:.0f} KiB "
          f"(kv-bits {args.kv_bits}{paged_note}{chunk_note}{prefix_note}"
          f"{oc_note}, {dev.type})")
    if args.over_commit:
        for tier in sorted(stats.tier_latency, reverse=True):
            t = stats.tier_latency[tier]
            print(f"[tier {tier}] {t.requests} requests, first-token "
                  f"p50/p99 {t.first_token_p50:.0f}/{t.first_token_p99:.0f} "
                  f"steps, inter-token p50/p99 {t.inter_token_p50:.1f}/"
                  f"{t.inter_token_p99:.1f} steps")
    if telemetry is not None:
        _report_telemetry(args, telemetry, writes)
    if args.stats_json:
        if writes:
            with open(args.stats_json, "w") as f:
                json.dump(stats.to_json(), f, indent=2, default=str)
        print(f"[stats] ServeStats -> {args.stats_json}")

    if args.parity:
        def matches(b_reqs):
            """(greedy tokens that match, tokens compared, requests whose
            tokens are all the same) against the primary run."""
            pairs = list(zip(requests, b_reqs))
            matched = sum(1 for r, b in pairs
                          for x, y in zip(r.tokens_out, b.tokens_out)
                          if x == y)
            total = sum(min(len(r.tokens_out), len(b.tokens_out))
                        for r, b in pairs)
            same = sum(1 for r, b in pairs if r.tokens_out == b.tokens_out)
            return matched, total, same

        def compare(tag, b_reqs, ok_msg):
            mismatch = [r.rid for r, b in zip(requests, b_reqs)
                        if r.tokens_out != b.tokens_out]
            if args.kv_bits == 4:
                # the dynamic per-slot int4 grids round-trip prefill reads
                # approximately, so drift is reported, not asserted
                matched, total, same = matches(b_reqs)
                print(f"[parity] {tag}: {matched}/{total} greedy tokens "
                      f"match ({matched / max(total, 1):.1%}), "
                      f"{same}/{len(requests)} requests identical — int4 "
                      f"dynamic per-slot grids round-trip prefill reads "
                      f"approximately, so drift is reported, not asserted")
                return
            if mismatch:
                raise SystemExit(f"[parity] FAIL: request ids {mismatch} "
                                 f"diverge between {tag}")
            print(f"[parity] OK: {ok_msg}")

        other = ("static" if args.scheduler == "continuous"
                 else "continuous")
        other_reqs = make_requests()
        run(other, other_reqs)
        compare(f"{args.scheduler} vs {other} schedulers", other_reqs,
                f"{args.scheduler} and {other} schedulers emit identical "
                f"greedy tokens for all {len(requests)} requests")
        if args.prefill_chunk:
            unchunked_reqs = make_requests()
            run(args.scheduler, unchunked_reqs)
            compare("chunked vs unchunked prefill", unchunked_reqs,
                    f"chunked (<= {args.prefill_chunk} tokens) and "
                    f"unchunked prefill emit identical greedy tokens "
                    f"for all {len(requests)} requests")
        if args.paged_kv:
            dense_reqs = make_requests()
            run(args.scheduler, dense_reqs, paged=False,
                chunk=args.prefill_chunk)
            compare("paged vs dense caches", dense_reqs,
                    f"paged and dense caches emit identical greedy "
                    f"tokens for all {len(requests)} requests "
                    f"(kv-bits {args.kv_bits})")
        if args.prefix_cache:
            unshared_reqs = make_requests()
            run(args.scheduler, unshared_reqs, chunk=args.prefill_chunk,
                prefix=False)
            compare("prefix-shared vs unshared serving", unshared_reqs,
                    f"prefix-shared and unshared serving emit identical "
                    f"greedy tokens for all {len(requests)} requests "
                    f"(kv-bits {args.kv_bits})")
        if args.over_commit:
            # preempted == unpreempted: the same requests served with
            # worst-case reservations (FIFO backpressure, no preemption)
            unpreempted_reqs = make_requests()
            run(args.scheduler, unpreempted_reqs, chunk=args.prefill_chunk,
                over_commit=False)
            compare("preempted (over-commit) vs unpreempted serving",
                    unpreempted_reqs,
                    f"preempted (over-commit, {stats.preemptions} "
                    f"preemptions) and unpreempted serving emit identical "
                    f"greedy tokens for all {len(requests)} requests "
                    f"(kv-bits {args.kv_bits})")
        if args.kv_bits == 4:
            # int4 vs int8 is lossy by construction: the token match rate
            int8_reqs = make_requests()
            run(args.scheduler, int8_reqs, chunk=args.prefill_chunk,
                kv_bits=8)
            matched, total, same = matches(int8_reqs)
            print(f"[parity] int4 vs int8 KV cache drift: "
                  f"{matched}/{total} greedy tokens match "
                  f"({matched / max(total, 1):.1%}), "
                  f"{same}/{len(requests)} requests identical end-to-end")
    return stats


if __name__ == "__main__":
    main()
