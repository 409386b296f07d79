#!/usr/bin/env python3
"""Time the port's kernels of two source trees on one GPU, in turns (A, B,
B, A), so two versions are compared on the same card in the same run, and
check that both trees compute the same bytes.

    python3 scripts/kernel_ab.py TREE_A TREE_B

TREE_A and TREE_B are repository roots (for example the parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists,
and ``.``). Each turn is its own process: it imports ``repro_torch`` from
that tree, builds its kernels there (``build/kernels``), checks each
kernel against its plain version and times it as ``chip_smoke.py`` does
(CUDA events, L2 flushed before every call, median of 20), and takes a
digest of each output on the same seeded inputs. The cases are K1
``rms_quantize`` at the decode rows (4 x 2304) and a prefill chunk (64
x 2304), K8/K9 at 64 x 2304, K2 ``int8_matmul_peg`` and K2-w4 at
``chip_smoke.py``'s phase-2 shapes (64 and 4 rows of the full-width FFN,
G = 4 and 6, f32 and requant outputs, and the reduced width's 4 x 16
groups), K4 ``peg_quantize`` (f32 wo rows and bf16 rows in 4 groups), K10
on bf16 rows, K5 / K6 two-pass at the full-width decode shapes (S or
s_cap 128 and 4096, kv 8 and 4), K6 one pass, K6 emitting the int8 wo
input from its merge (a tree whose K6 has no emit runs K6, then K4), and
K7 two-pass on bf16 and f32 arenas at s_cap 128 and 4096, with K7 on bf16
emitting the int8 wo input at s_cap 128 (a tree whose K7 has no emit runs
K7, then K4), and K5 / K6 (kv 8 and 4) and K7 (bf16) two-pass at G 16
(4 kv heads) and G 48 (1 kv head), hd 128, 128 cells.
Each turn then serves the README quickstart at the reduced width (kv 8,
and w4 / kv4) and takes a digest of its greedy tokens. Prints one line per
case with the two trees' medians over their two turns, B / A and whether
all four turns' outputs have the same bytes, whether the four turns served
the same tokens, then the card's name and power limit; exits 1 when any
case's bytes or tokens differ. K7's cases are the exception: two designs
of K7 sum floats in other orders, so each turn holds K7 to its plain
version with chip_smoke's attention bounds (``attend_check``; the emit to
within 1 LSB on 0.1 % of the elements), the two turns of one tree must
agree bit for bit, and the largest |B - A| between the trees is printed.
"""
from __future__ import annotations

import contextlib
import hashlib
import inspect
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
D, FF, Q_OUT = 2304, 9216, 2048         # gemma2-2b widths
B, ATT = 4, (4, 4, 2, 256)               # decode lanes, attention shape


def cases():
    """({name: (kernel call, plain call)}, each a function of no arguments,
    on the card; {name of a K7 case: (softmax_out step, max|v|), or None
    for its int8 emit})."""
    import torch
    from repro_torch.kernels import fused_ln_quant as lnq
    from repro_torch.kernels import int8_attend_decode as iad
    from repro_torch.kernels import int8_matmul as imm
    from repro_torch.kernels import paged_attend_decode as pad
    from repro_torch.kernels import peg_quant as pq
    from repro_torch.kernels.nibble import pack_nibbles, pack_rows
    from repro_torch.kernels.ref import w_colsum_groups
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def ru(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    def ri(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def bind(kernel, plain, *args, **kw):
        return (lambda: kernel(*args, **kw)), (lambda: plain(*args, **kw))

    # bounds: (softmax_out step, max|v|, share of rows that may sit off by
    # up to one step x max|v|) for ``attend_check``; past 8 heads of K5 /
    # K6 any row may (a row on a grid tie sits one step off there;
    # chip_smoke's ``tie_check`` explains such rows). k7: the K7 cases,
    # equal within a tree; every other case is equal across trees
    out, bounds, k7 = {}, {}, set()
    q8 = dict(qmin=-128, qmax=127)
    for rows in (B, 16 * B):
        for g in (1, 4):
            x = (randn(rows, D) * 3).to(torch.bfloat16)
            out[f"rms_quantize ({rows},{D}) bf16 G={g}"] = bind(
                lnq.rms_quantize_cuda, lnq.rms_quantize_plain, x,
                randn(D) * 0.1, ru(0.02, 0.05, g),
                torch.round(ru(-20, 20, g)), **q8)
    x = (randn(16 * B, D) * 3).to(torch.bfloat16)
    s, z = ru(0.02, 0.05, 1), torch.round(ru(-20, 20, 1))
    gamma, beta = 1 + randn(D) * 0.1, randn(D) * 0.1
    for name, affine in (("ln_quantize", (gamma, beta)),
                         ("rms_fake_quant", (gamma,)),
                         ("ln_fake_quant", (gamma, beta))):
        out[f"{name} ({16 * B},{D}) bf16 G=1"] = bind(
            getattr(lnq, name + "_cuda"), getattr(lnq, name + "_plain"), x,
            *affine, s, z, **q8)

    # K2 / K2-w4 at chip_smoke's phase-2 shapes
    for w_bits, m, k, n, g in (
            (8, 16 * B, D, FF, 4), (8, B, D, FF, 4), (8, 16 * B, D, FF, 6),
            (8, B, D, FF, 6), (8, 2 * B, 64, 128, 4), (4, 16 * B, D, FF, 4),
            (4, B, D, FF, 4), (4, 16 * B, 64, 128, 4),
            (4, 2 * B, 64, 128, 4)):
        a = ri(-128, 128, m, k)
        w = ri(-7, 8, k, n) if w_bits == 4 else ri(-127, 128, k, n)
        w_q = pack_rows(w) if w_bits == 4 else w
        args = (a, w_q, ru(0.01, 0.05, g), torch.round(ru(-20, 20, g)),
                ru(0.001, 0.01, 1), w_colsum_groups(w, g))
        requant = dict(activation="gelu", mul=randn(m, n),
                       out_scale=ru(0.02, 0.04, 1),
                       out_zp=torch.round(ru(-5, 5, 1)))
        tag = "_w4" if w_bits == 4 else ""
        for label, kw in (("f32 out", {}), ("gelu*mul->int8", requant)):
            out[f"int8_matmul_peg{tag} ({m},{k})x({k},{n}) G={g} "
                f"{label}"] = bind(imm.int8_matmul_peg_cuda,
                                   imm.int8_matmul_peg_plain, *args,
                                   w_bits=w_bits, **kw)

    # K4 (the wo rows, and bf16 rows in 4 groups) and K10 (bf16 rows)
    for rows, d, dtype, g in ((16 * B, Q_OUT, torch.float32, 1),
                              (B, Q_OUT, torch.float32, 1),
                              (16 * B, D, torch.bfloat16, 4)):
        x = randn(rows, d).to(dtype)
        out[f"peg_quantize ({rows},{d}) {str(dtype)[6:]} G={g}"] = bind(
            pq.peg_quantize_cuda, pq.peg_quantize_plain, x,
            ru(0.01, 0.03, g), torch.round(ru(-10, 10, g)), **q8)
    x = (randn(16 * B, D) * 3).to(torch.bfloat16)
    for g in (1, 4):
        out[f"peg_fake_quant ({16 * B},{D}) bf16 G={g}"] = bind(
            pq.peg_fake_quant_cuda, pq.peg_fake_quant_plain, x,
            ru(0.02, 0.05, g), torch.round(ru(-20, 20, g)), **q8)

    b, kv, g, hd = ATT
    sites = dict(sm_quant=torch.tensor([0.05, 128.0], device=dev),
                 sm_qmin=0, sm_qmax=255,
                 smo_quant=torch.tensor([1 / 255, 0.0], device=dev),
                 smo_qmin=0, smo_qmax=255)
    one_pass = dict(sites, smo_quant=None)
    emits, k7_emits = ("out_scale" in inspect.signature(fn).parameters
                       for fn in (pad.paged_int8_attend_decode_cuda,
                                  pad.paged_attend_decode_cuda))
    for kv_bits in (8, 4):
        def payload(*shape):
            if kv_bits == 4:
                return pack_nibbles(ri(-8, 8, *shape))
            return ri(-127, 128, *shape)
        zlim = 3 if kv_bits == 4 else 20
        tag = "" if kv_bits == 8 else "_kv4"
        for s_len, window in ((128, 64), (4096, 2048)):
            k_pos = torch.arange(s_len, device=dev,
                                 dtype=torch.int32).repeat(b, 1)
            q_pos = torch.full((b,), s_len - 1, device=dev,
                               dtype=torch.int32)
            args = (ri(-127, 128, b, kv, g, hd), ru(0.01, 0.03, b, kv, g) /
                    16, torch.round(ru(-20, 20, b, kv, g)),
                    torch.round(ru(-zlim, zlim, b, kv)),
                    torch.round(ru(-zlim, zlim, b, kv)),
                    payload(b, s_len, kv, hd), ru(0.01, 0.05, b, s_len, kv),
                    payload(b, s_len, kv, hd), ru(0.01, 0.05, b, s_len, kv),
                    k_pos, q_pos)
            out[f"int8_attend_decode{tag} S{s_len} two-pass"] = bind(
                iad.int8_attend_decode_cuda, iad.int8_attend_decode_plain,
                *args, window=window, logit_softcap=50.0, kv_bits=kv_bits,
                **sites)
            bs, nb = 16, s_len // 16
            n_blocks = b * nb + 5
            table = torch.randperm(n_blocks, generator=gen, device=dev)[
                :b * nb].reshape(b, nb).to(torch.int32)
            args = (ri(-127, 128, b, kv, g, hd), ru(0.01, 0.03, b, kv, g) /
                    16, torch.round(ru(-20, 20, b, kv, g)),
                    torch.round(ru(-zlim, zlim, b, kv)),
                    torch.round(ru(-zlim, zlim, b, kv)),
                    payload(n_blocks, bs, kv, hd),
                    ru(0.01, 0.05, n_blocks, bs, kv),
                    payload(n_blocks, bs, kv, hd),
                    ru(0.01, 0.05, n_blocks, bs, kv), table, q_pos)
            for label, site_kw in (("two-pass", sites),
                                   ("one pass", one_pass)):
                if label == "one pass" and s_len != 128:
                    continue
                out[f"paged_int8_attend_decode{tag} s_cap{s_len} "
                    f"{label}"] = bind(
                        pad.paged_int8_attend_decode_cuda,
                        pad.paged_int8_attend_decode_plain, *args,
                        s_cap=s_len, window=window, logit_softcap=50.0,
                        kv_bits=kv_bits, **site_kw)
            if s_len == 128:           # K6 emitting the int8 wo input
                kw = dict(s_cap=s_len, window=window, logit_softcap=50.0,
                          kv_bits=kv_bits, **sites)
                grid = (torch.tensor([0.01], device=dev),
                        torch.tensor([3.0], device=dev))
                out[f"paged_int8_attend_decode{tag} s_cap{s_len} two-pass "
                    f"emitting int8"] = tuple(
                        emit_call(fn, pq.peg_quantize_cuda if cuda else
                                  pq.peg_quantize_plain, emits, args, kw,
                                  grid)
                        for fn, cuda in (
                            (pad.paged_int8_attend_decode_cuda, True),
                            (pad.paged_int8_attend_decode_plain, False)))
            if kv_bits == 8:    # K7 on bf16 and f32 arenas of the same table
                q7 = randn(b, kv, g, hd) * 0.3 / hd ** 0.5
                kw = dict(s_cap=s_len, window=window, logit_softcap=50.0,
                          **sites)
                for dt, label in ((torch.bfloat16, "bf16"),
                                  (torch.float32, "f32")):
                    kf, vf = (randn(n_blocks, bs, kv, hd).to(dt)
                              for _ in range(2))
                    args = (q7, kf, vf, table, q_pos)
                    name = f"paged_attend_decode {label} s_cap{s_len} two-pass"
                    out[name] = bind(pad.paged_attend_decode_cuda,
                                     pad.paged_attend_decode_plain, *args,
                                     **kw)
                    bounds[name] = (1 / 255, float(vf.float().abs().max()),
                                    1e-3)
                    k7.add(name)
                    if s_len == 128 and label == "bf16":
                        grid = (torch.tensor([0.01], device=dev),
                                torch.tensor([3.0], device=dev))
                        name += " emitting int8"
                        out[name] = tuple(
                            emit_call(fn, pq.peg_quantize_cuda if cuda else
                                      pq.peg_quantize_plain, k7_emits, args,
                                      kw, grid)
                            for fn, cuda in (
                                (pad.paged_attend_decode_cuda, True),
                                (pad.paged_attend_decode_plain, False)))
                        k7.add(name)
    # past 8 query heads a kv head (hd 128): qwen3-moe's G 16 on 4 kv heads
    # and granite-20b's G 48 on one, dense and paged, 128 cells
    for kv, g in ((4, 16), (1, 48)):
        hd, s_len, bs = 128, 128, 16
        nb = s_len // bs
        n_blocks = b * nb + 5
        table = torch.randperm(n_blocks, generator=gen, device=dev)[
            :b * nb].reshape(b, nb).to(torch.int32)
        k_pos = torch.arange(s_len, device=dev, dtype=torch.int32).repeat(
            b, 1)
        q_pos = torch.full((b,), s_len - 1, device=dev, dtype=torch.int32)
        for kv_bits in (8, 4):
            tag = "" if kv_bits == 8 else "_kv4"
            zlim = 3 if kv_bits == 4 else 20

            def payload(*shape):
                if kv_bits == 4:
                    return pack_nibbles(ri(-8, 8, *shape))
                return ri(-127, 128, *shape)
            q = (ri(-127, 128, b, kv, g, hd), ru(0.01, 0.03, b, kv, g) / 16,
                 torch.round(ru(-20, 20, b, kv, g)),
                 torch.round(ru(-zlim, zlim, b, kv)),
                 torch.round(ru(-zlim, zlim, b, kv)))
            dense = q + (payload(b, s_len, kv, hd),
                         ru(0.01, 0.05, b, s_len, kv),
                         payload(b, s_len, kv, hd),
                         ru(0.01, 0.05, b, s_len, kv), k_pos, q_pos)
            v_abs = (8 + zlim if kv_bits == 4 else 128 + zlim) * 0.05
            name = f"int8_attend_decode{tag} G{g} hd{hd} S{s_len} two-pass"
            bounds[name] = (1 / 255, v_abs, 1.0)
            out[name] = bind(
                    iad.int8_attend_decode_cuda, iad.int8_attend_decode_plain,
                    *dense, window=None, logit_softcap=None,
                    kv_bits=kv_bits, **sites)
            paged = q + (payload(n_blocks, bs, kv, hd),
                         ru(0.01, 0.05, n_blocks, bs, kv),
                         payload(n_blocks, bs, kv, hd),
                         ru(0.01, 0.05, n_blocks, bs, kv), table, q_pos)
            name = (f"paged_int8_attend_decode{tag} G{g} hd{hd} "
                    f"s_cap{s_len} two-pass")
            bounds[name] = (1 / 255, v_abs, 1.0)
            out[name] = bind(
                    pad.paged_int8_attend_decode_cuda,
                    pad.paged_int8_attend_decode_plain, *paged,
                    s_cap=s_len, window=None, logit_softcap=None,
                    kv_bits=kv_bits, **sites)
        q7 = randn(b, kv, g, hd) * 0.3 / hd ** 0.5
        kf, vf = (randn(n_blocks, bs, kv, hd).to(torch.bfloat16)
                  for _ in range(2))
        name = f"paged_attend_decode bf16 G{g} hd{hd} s_cap{s_len} two-pass"
        out[name] = bind(pad.paged_attend_decode_cuda,
                         pad.paged_attend_decode_plain, q7, kf, vf, table,
                         q_pos, s_cap=s_len, window=None, logit_softcap=None,
                         **sites)
        bounds[name] = (1 / 255, float(vf.float().abs().max()), 1e-3)
        k7.add(name)
    return out, bounds, k7


def emit_call(attend, quantize, emits, args, kw, grid):
    """A decode-attention call returning the (B, H*hd) int8 wo input on
    ``grid``: the fused emit where the tree's wrapper has it, else the f32
    call followed by ``quantize`` (K4)."""
    s_o, z_o = grid
    if emits:
        return lambda: attend(*args, **kw, out_scale=s_o, out_zp=z_o,
                              qmin=-128, qmax=127)
    return lambda: quantize(attend(*args, **kw).reshape(args[0].shape[0],
                                                        -1),
                            s_o, z_o, qmin=-128, qmax=127)


def digest(t) -> str:
    """A hash of the tensor's bytes (bf16 read as int16)."""
    import torch
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()
                          ).hexdigest()[:16]


def one(tree: Path, saved: Path) -> dict:
    """Build the tree's kernels, check and time every case; {case: (ms,
    digest of the output)}. K7's outputs are saved to ``saved``."""
    import torch
    sys.path.insert(0, str(HERE))
    # (puts this tree's src on the path)
    from chip_smoke import attend_check, time_ms
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import _build
    if Path(_build.__file__).resolve().parents[3] != tree:
        raise RuntimeError(f"imported {_build.__file__}, not from {tree}")
    _build.build_all()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    results, k7_out = {}, {}
    all_cases, bounds, k7 = cases()
    for name, (kernel, plain) in all_cases.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        if name in bounds:
            attend_check(got, want, *bounds[name])
            off = 0
        elif got.dtype == torch.int8:
            off = int(((got.int() - want.int()).abs() > 1).sum())
        else:
            err = (got.float() - want.float()).abs()
            off = int((err > 1e-2 * float(want.float().abs().max())).sum())
        if off > 1e-3 * got.numel():
            raise RuntimeError(f"{name}: {off} elements off the plain version")
        if name in k7:
            k7_out[name] = got.cpu()
        results[name] = (time_ms(kernel, flush), digest(got))
    torch.save(k7_out, saved)
    return results


def quickstart_tokens() -> dict:
    """{run: a digest of every request's greedy tokens} of the README
    quickstart at the reduced width, at 8 bits and at 4, served by this
    tree's launcher on the card (the primary run of each)."""
    from repro_torch.launch import serve as launcher
    argv = ["--arch", "gemma2-2b", "--reduced", "--requests", "6",
            "--prompt-len", "24", "--new-tokens", "6", "--max-len", "64",
            "--quantize", "--deploy-int8", "--scheduler", "continuous",
            "--paged-kv", "--block-size", "8", "--prefill-chunk", "8"]
    runs, served = {}, []
    orig = launcher.serve

    def serve(*args, **kw):
        served.append(args[4])                # the requests
        return orig(*args, **kw)
    launcher.serve = serve
    try:
        for name, extra in (("kv8", ["--kv-bits", "8"]),
                            ("w4 kv4", ["--kv-bits", "4", "--weight-bits",
                                        "4"])):
            served.clear()
            launcher.main(argv + extra)
            runs[name] = hashlib.sha256(json.dumps(
                [r.tokens_out for r in served[0]]).encode()).hexdigest()[:16]
    finally:
        launcher.serve = orig
    return runs


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        results = one(Path(sys.argv[2]).resolve(), Path(sys.argv[3]))
        with contextlib.redirect_stdout(sys.stderr):
            tokens = quickstart_tokens()
        print(json.dumps({"kernels": results, "tokens": tokens}))
        return 0
    import torch
    a, b = (Path(p).resolve() for p in sys.argv[1:3])
    runs, saved = {a: [], b: []}, {a: [], b: []}
    scratch = HERE / "build" / "kernel_ab"
    scratch.mkdir(parents=True, exist_ok=True)
    for turn, tree in enumerate((a, b, b, a)):
        out = scratch / f"k7_turn{turn}.pt"
        proc = subprocess.run([sys.executable, __file__, "--one", str(tree),
                               str(out)], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return 1
        runs[tree].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        saved[tree].append(torch.load(out))
    differ = []
    kernels = [{n: r["kernels"][n] for n in r["kernels"]}
               for r in runs[a] + runs[b]]
    for name in kernels[0]:
        ta = statistics.median(k[name][0] for k in kernels[:2]) * 1e3
        tb = statistics.median(k[name][0] for k in kernels[2:]) * 1e3
        turns = " ".join(f"{k[name][0] * 1e3:.1f}" for k in kernels)
        if name in saved[a][0]:      # K7: equal within a tree, |B - A| shown
            same = all(len({k[name][1] for k in ks}) == 1
                       for ks in (kernels[:2], kernels[2:]))
            gap = float((saved[b][0][name].float() -
                         saved[a][0][name].float()).abs().max())
            verdict = (f"bytes {'equal' if same else 'DIFFER'} within each "
                       f"tree, max |B - A| {gap:.3e}")
        else:
            same = len({k[name][1] for k in kernels}) == 1
            verdict = f"bytes {'equal' if same else 'DIFFER'}"
        if not same:
            differ.append(name)
        print(f"[ab] {name}: A {ta:.1f} us  B {tb:.1f} us  B/A {tb / ta:.3f}"
              f"  (turns A A B B: {turns}); {verdict}")
    for name in runs[a][0]["tokens"]:
        same = len({r["tokens"][name] for r in runs[a] + runs[b]}) == 1
        if not same:
            differ.append(f"quickstart {name}")
        print(f"[ab] README quickstart (reduced, {name}) greedy tokens: "
              f"{'equal' if same else 'DIFFER'} in all four turns")
    total = len(kernels[0]) + len(runs[a][0]["tokens"])
    print(f"[ab] {total - len(differ)} of {total} cases: the same bytes in "
          f"all four turns (K7: within each tree)"
          + (f"; differ: {differ}" if differ else ""))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
