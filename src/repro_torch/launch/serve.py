"""Serving launcher (port of ``repro.launch.serve``): batched requests
against gemma2-2b, optionally W8A8-quantized — prefill + decode with a KV
cache, static or continuous scheduler.

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
chunks of N prompt tokens; ``--parity`` serves the requests again under
the other scheduler, unchunked and dense and checks the greedy tokens are
the same.

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
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import Mode, QuantCtx, build_deploy, peg_policy, ptq
from repro_torch.core.quant_config import QuantizerConfig, RangeEstimator
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.runtime import (BlockPool, Request, blocks_for_tokens,
                                 make_admit_step, make_chunk_prefill_step,
                                 make_decode_step, make_prefill_step, serve)
from repro_torch.runtime.serve_loop import _check_capacity

# flags (by dest) the port serves; any other flag must keep its default
_PORTED = {"arch", "reduced", "requests", "prompt_len", "new_tokens",
           "batch_slots", "max_len", "skew", "seed", "quantize",
           "deploy_int8", "scheduler", "kv_bits", "weight_bits", "parity",
           "paged_kv", "block_size", "num_blocks", "prefill_chunk"}


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
                    help="shard the engine tensor-parallel over N devices "
                         "(jax.sharding mesh (1, N) over (data, model); "
                         "admission stays host-local, the admit mask "
                         "broadcasts replicated). On CPU, simulate "
                         "devices with XLA_FLAGS="
                         "--xla_force_host_platform_device_count=N "
                         "(requires --reduced; 1 = unsharded)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def _reject_unported(ap: argparse.ArgumentParser, args) -> None:
    for action in ap._actions:
        dest = action.dest
        if dest == "help" or not action.option_strings:
            continue
        value = getattr(args, dest)
        if dest not in _PORTED and value != ap.get_default(dest):
            ap.error(f"{action.option_strings[0]} is not yet ported")


def _fallback_note(cfg, packed, qm) -> str:
    """Which blocks serve on the integer kernels, and why the others fall
    back to fake-quant."""
    from repro_torch.core import deploy
    blocks = packed["scan"]
    n_attn = sum(cfg.n_super for b in blocks if deploy.is_packed(
        b["attn"].get("wq")))
    n_ffn = sum(cfg.n_super for b in blocks if deploy.is_packed(
        b["ffn"].get("w_gate")))
    note = (f"[deploy-int8] integer kernels: attention projections in "
            f"{n_attn}/{cfg.num_layers} layers, FFN in "
            f"{n_ffn}/{cfg.num_layers} layers")
    if n_ffn < cfg.num_layers:
        spec = qm.peg_specs.get("layer0/ffn_in")
        why = ("" if spec is None else
               f" (ffn_in PEG groups {spec.group_sizes.tolist()} are not "
               f"uniform)")
        note += f"; fake-quant fallback: layer/ffn{why}"
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


def main(argv=None, *, device=None, dtype=None):
    """Parse ``argv`` and serve. ``dtype`` overrides the params' dtype
    (bf16 at full width, f32 with ``--reduced``)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    _check_args(ap, args)
    dev = resolve_device(device)
    if dev.type == "cuda":
        # f32 matmuls in full f32, as the reference computes them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    try:
        cfg = get_config(args.arch)
    except KeyError as e:
        ap.error(str(e))
    if args.reduced:
        cfg = cfg.reduced()
    if dtype is None:
        dtype = torch.float32 if args.reduced else torch.bfloat16

    # per-lane table width (ring-bounded for all-window models) and pool
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
    # fail before the model is built on workloads the serve loop would
    # reject (the same check serve() runs on the real requests)
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

    params = tfm.init_params(cfg, args.seed, stacked=True, dtype=dtype,
                             device=dev)
    ctx_factory = None
    if args.quantize:
        params, ctx_factory = _quantize(cfg, args, params, dtype, dev)

    prefill = make_prefill_step(cfg, ctx_factory=ctx_factory)
    admit = make_admit_step(cfg, ctx_factory=ctx_factory)
    decode = make_decode_step(cfg, ctx_factory=ctx_factory)
    chunk_step = make_chunk_prefill_step(cfg, ctx_factory=ctx_factory)

    def make_requests():
        rng = np.random.RandomState(args.seed)
        return [Request(rid=i,
                        prompt=rng.randint(10, cfg.vocab_size,
                                           size=args.prompt_len
                                           ).astype(np.int64),
                        max_new_tokens=(args.skew if args.skew and i % 2
                                        else args.new_tokens))
                for i in range(args.requests)]

    def init_cache(batch, paged, scheduler, kv_bits):
        kw = dict(dtype=dtype, kv_bits=kv_bits, device=dev)
        if not paged:
            return tfm.init_cache(cfg, batch, args.max_len, **kw)
        if scheduler == "static":
            # fully mapped identity table: the static loop has no pool
            return tfm.init_cache(cfg, batch, args.max_len, paged=True,
                                  block_size=args.block_size, **kw)
        return tfm.init_cache(cfg, batch, args.max_len, paged=True,
                              block_size=args.block_size,
                              num_blocks=num_blocks, mapped=False, **kw)

    def run(scheduler, requests, paged=None, chunk=0, kv_bits=None):
        paged = args.paged_kv if paged is None else paged
        kv_bits = args.kv_bits if kv_bits is None else kv_bits
        pool = None
        if paged and scheduler == "continuous":
            pool = BlockPool(num_blocks, args.block_size, args.batch_slots,
                             nb_lane)
        return serve(prefill, decode,
                     lambda b: init_cache(b, paged, scheduler, kv_bits),
                     params,
                     requests, scheduler=scheduler,
                     batch_slots=args.batch_slots, max_len=args.max_len,
                     admit_step=admit,
                     chunk_step=chunk_step if chunk else None,
                     block_pool=pool, prefill_chunk=chunk or None,
                     ring_tokens=ring_tokens if pool else None,
                     device=dev)

    requests = make_requests()
    stats = run(args.scheduler, requests, chunk=args.prefill_chunk)
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
    print(f"[serve:{args.scheduler}] {stats.tokens_generated} tokens, "
          f"{stats.decode_steps} decode steps, "
          f"{stats.prefill_calls} prefills, {stats.wall_s:.2f}s "
          f"({stats.tokens_per_s:.1f} tok/s), "
          f"slot-utilization {stats.slot_utilization:.0%}, "
          f"peak kv-cache {stats.cache_bytes / 1024:.0f} KiB "
          f"(kv-bits {args.kv_bits}{paged_note}{chunk_note}, {dev.type})")

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
