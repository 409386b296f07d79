"""Serving launcher (port of ``repro.launch.serve``): batched requests
against gemma2-2b, optionally W8A8-quantized — prefill + decode with a dense
KV cache, static scheduler.

``--quantize`` calibrates W8A8 PTQ with the paper's PEG recipe
(``peg_policy(4)``) and serves simulated quantization (fake-quant);
``--quantize --deploy-int8`` serves the integer path: weights pre-packed to
int8 and the attention / FFN projections on the hand-written kernels
(``rms_quantize -> int8_matmul_peg (fused epilogue) -> int8_matmul``), with
a parity check against the fake-quant reference printed at startup.

Full width serves bf16 params on one GPU; ``--reduced`` serves the small
f32 config. Every other flag of the reference launcher is accepted by the
parser and rejected with "not yet ported" when set.

    python -m repro_torch.launch.serve --arch gemma2-2b --reduced \
        --requests 6 --prompt-len 24 --new-tokens 6 --max-len 64 \
        --quantize --deploy-int8

``main(argv, device="cpu")`` runs the plain PyTorch versions on the CPU.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import Mode, QuantCtx, build_deploy, peg_policy, ptq
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.runtime import (Request, make_decode_step,
                                 make_prefill_step, serve)
from repro_torch.runtime.serve_loop import _check_capacity

# flags (by dest) this slice serves; any other flag must keep its default
_PORTED = {"arch", "reduced", "requests", "prompt_len", "new_tokens",
           "batch_slots", "max_len", "skew", "seed", "quantize",
           "deploy_int8", "scheduler", "kv_bits", "weight_bits"}
_PORTED_VALUES = {"scheduler": "static", "kv_bits": 16, "weight_bits": 8}


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
        if dest in _PORTED_VALUES and value != _PORTED_VALUES[dest]:
            ap.error(f"{action.option_strings[0]} {value} is not yet ported "
                     f"(this slice serves {_PORTED_VALUES[dest]})")
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
    return note


def main(argv=None, *, device=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.deploy_int8 and not args.quantize:
        ap.error("--deploy-int8 requires --quantize")
    _reject_unported(ap, args)
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
        dtype = torch.float32
    else:
        dtype = torch.bfloat16
    try:
        _check_capacity([Request(rid=-1,
                                 prompt=np.zeros(args.prompt_len, np.int32),
                                 max_new_tokens=max(args.new_tokens,
                                                    args.skew))],
                        args.max_len)
    except ValueError as e:
        ap.error(f"--max-len too small: {e}")

    params = tfm.init_params(cfg, args.seed, stacked=True, dtype=dtype,
                             device=dev)
    ctx_factory = None
    if args.quantize:
        # calibrate on a few synthetic prompts with the unrolled layout,
        # then serve with layer-shared quant params (layer 0's win)
        pol = peg_policy(4)
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

        if args.deploy_int8:
            fp_params = params
            params, deploy_acts = build_deploy(cfg, params, pol, state)

            def ctx_factory():
                return QuantCtx(policy=pol, mode=Mode.DEPLOY,
                                act_state=state, deploy_acts=deploy_acts,
                                weight_cache=weight_cache)

            # parity: integer path vs the fake-quant reference it replaces
            toks = torch.as_tensor(np.random.RandomState(99).randint(
                0, cfg.vocab_size, (2, args.prompt_len)), device=dev)
            ref_ctx = QuantCtx(policy=pol, mode=Mode.APPLY, act_state=state,
                               weight_cache=weight_cache)
            with torch.no_grad():
                logits_ref, _ = tfm.forward(cfg, fp_params, toks, ctx=ref_ctx)
                logits_int, _ = tfm.forward(cfg, params, toks,
                                            ctx=ctx_factory())
            diff = float((logits_ref.float() - logits_int.float()).abs().max())
            scale = float(logits_ref.float().abs().max()) + 1e-9
            print(f"[deploy-int8] max |fake-quant - int8| logits diff "
                  f"{diff:.5f} (rel {diff / scale:.4%})")
            print(_fallback_note(cfg, params, qm))
        else:
            def ctx_factory():
                return QuantCtx(policy=pol, mode=Mode.APPLY, act_state=state,
                                weight_cache=weight_cache)

    def make_requests():
        rng = np.random.RandomState(args.seed)
        return [Request(rid=i,
                        prompt=rng.randint(10, cfg.vocab_size,
                                           size=args.prompt_len
                                           ).astype(np.int64),
                        max_new_tokens=(args.skew if args.skew and i % 2
                                        else args.new_tokens))
                for i in range(args.requests)]

    stats = serve(make_prefill_step(cfg, ctx_factory=ctx_factory),
                  make_decode_step(cfg, ctx_factory=ctx_factory),
                  lambda b: tfm.init_cache(cfg, b, args.max_len, dtype=dtype,
                                           device=dev),
                  params, make_requests(), scheduler="static",
                  batch_slots=args.batch_slots, max_len=args.max_len,
                  device=dev)
    print(f"[serve:static] {stats.tokens_generated} tokens, "
          f"{stats.decode_steps} decode steps, "
          f"{stats.prefill_calls} prefills, {stats.wall_s:.2f}s "
          f"({stats.tokens_per_s:.1f} tok/s), "
          f"slot-utilization {stats.slot_utilization:.0%}, "
          f"peak kv-cache {stats.cache_bytes / 1024:.0f} KiB "
          f"(kv-bits {args.kv_bits}, {dev.type})")
    return stats


if __name__ == "__main__":
    main()
