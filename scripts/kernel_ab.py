#!/usr/bin/env python3
"""Time the port's row-norm and decode-attention kernels of two source
trees on one GPU, in turns (A, B, B, A), so two versions are compared on
the same card in the same run.

    python3 scripts/kernel_ab.py TREE_A TREE_B

TREE_A and TREE_B are repository roots (for example the parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists,
and ``.``). Each turn is its own process: it imports ``repro_torch`` from
that tree, builds its kernels there (``build/kernels``), checks each
kernel against its plain version and times it as ``chip_smoke.py`` does
(CUDA events, L2 flushed before every call, median of 20). The cases are
K1 ``rms_quantize`` at the decode rows (4 x 2304) and a prefill chunk (64
x 2304), K8/K9 at 64 x 2304, and K5 / K6 two-pass at the full-width
decode shapes (S or s_cap 128 and 4096, kv 8 and 4), K6 one pass and K7
on bf16 arenas.
Prints one line per case with the two trees' medians over their two turns
and B / A, then the card's name and power limit.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
D, B, ATT = 2304, 4, (4, 4, 2, 256)      # gemma2-2b widths, decode lanes


def cases():
    """{name: (kernel, plain, args, kwargs)} on the card."""
    import torch
    from repro_torch.kernels import fused_ln_quant as lnq
    from repro_torch.kernels import int8_attend_decode as iad
    from repro_torch.kernels import paged_attend_decode as pad
    from repro_torch.kernels.nibble import pack_nibbles
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def ru(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    def ri(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    out = {}
    q8 = dict(qmin=-128, qmax=127)
    for rows in (B, 16 * B):
        for g in (1, 4):
            x = (randn(rows, D) * 3).to(torch.bfloat16)
            args = (x, randn(D) * 0.1, ru(0.02, 0.05, g),
                    torch.round(ru(-20, 20, g)))
            out[f"rms_quantize ({rows},{D}) bf16 G={g}"] = (
                lnq.rms_quantize_cuda, lnq.rms_quantize_plain, args, q8)
    x = (randn(16 * B, D) * 3).to(torch.bfloat16)
    s, z = ru(0.02, 0.05, 1), torch.round(ru(-20, 20, 1))
    gamma, beta = 1 + randn(D) * 0.1, randn(D) * 0.1
    for name, affine in (("ln_quantize", (gamma, beta)),
                         ("rms_fake_quant", (gamma,)),
                         ("ln_fake_quant", (gamma, beta))):
        out[f"{name} ({16 * B},{D}) bf16 G=1"] = (
            getattr(lnq, name + "_cuda"), getattr(lnq, name + "_plain"),
            (x, *affine, s, z), q8)

    b, kv, g, hd = ATT
    sites = dict(sm_quant=torch.tensor([0.05, 128.0], device=dev),
                 sm_qmin=0, sm_qmax=255,
                 smo_quant=torch.tensor([1 / 255, 0.0], device=dev),
                 smo_qmin=0, smo_qmax=255)
    one_pass = dict(sites, smo_quant=None)
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
            kw = dict(window=window, logit_softcap=50.0, kv_bits=kv_bits,
                      **sites)
            out[f"int8_attend_decode{tag} S{s_len} two-pass"] = (
                iad.int8_attend_decode_cuda, iad.int8_attend_decode_plain,
                args, kw)
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
                kw = dict(s_cap=s_len, window=window, logit_softcap=50.0,
                          kv_bits=kv_bits, **site_kw)
                out[f"paged_int8_attend_decode{tag} s_cap{s_len} "
                    f"{label}"] = (pad.paged_int8_attend_decode_cuda,
                                   pad.paged_int8_attend_decode_plain, args,
                                   kw)
            if kv_bits == 8:           # K7 on bf16 arenas of the same table
                kf, vf = (randn(n_blocks, bs, kv, hd).to(torch.bfloat16)
                          for _ in range(2))
                kw = dict(s_cap=s_len, window=window, logit_softcap=50.0,
                          **sites)
                out[f"paged_attend_decode bf16 s_cap{s_len} two-pass"] = (
                    pad.paged_attend_decode_cuda,
                    pad.paged_attend_decode_plain,
                    (randn(b, kv, g, hd) * 0.3 / hd ** 0.5, kf, vf, table,
                     q_pos), kw)
    return out


def one(tree: Path) -> dict:
    """Build the tree's kernels, check and time every case; {case: ms}."""
    import torch
    sys.path.insert(0, str(HERE))
    from chip_smoke import time_ms        # (puts this tree's src on the path)
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import _build
    if Path(_build.__file__).resolve().parents[3] != tree:
        raise RuntimeError(f"imported {_build.__file__}, not from {tree}")
    _build.build_all()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    times = {}
    for name, (kernel, plain, args, kw) in cases().items():
        got, want = kernel(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        if got.dtype == torch.int8:
            off = int(((got.int() - want.int()).abs() > 1).sum())
        else:
            err = (got.float() - want.float()).abs()
            off = int((err > 1e-2 * float(want.float().abs().max())).sum())
        if off > 1e-3 * got.numel():
            raise RuntimeError(f"{name}: {off} elements off the plain version")
        times[name] = time_ms(lambda: kernel(*args, **kw), flush)
    return times


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(one(Path(sys.argv[2]).resolve())))
        return 0
    a, b = (Path(p).resolve() for p in sys.argv[1:3])
    runs = {a: [], b: []}
    for tree in (a, b, b, a):
        proc = subprocess.run([sys.executable, __file__, "--one", str(tree)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return 1
        runs[tree].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    for name in runs[a][0]:
        ta = statistics.median(r[name] for r in runs[a]) * 1e3
        tb = statistics.median(r[name] for r in runs[b]) * 1e3
        turns = " ".join(f"{r[name] * 1e3:.1f}" for r in runs[a] + runs[b])
        print(f"[ab] {name}: A {ta:.1f} us  B {tb:.1f} us  B/A {tb / ta:.3f}"
              f"  (turns A A B B: {turns})")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
