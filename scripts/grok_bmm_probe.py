#!/usr/bin/env python3
"""Why grok-1-314b's expert-parallel MoE block parts from the unsharded
block on the card (``chip_smoke.py``'s ``[tp2-moe-grok]``: 6.4e-07 of
max|out| on the card, 0.0 on the CPU).

    PYTHONPATH=src python3 scripts/grok_bmm_probe.py [--cpu]

grok-1's MoE block at published width (``chip_smoke.grok_block``: d 6144,
8 experts of d_ff 32768, top 2, bf16 experts promoted to the f32 rows, as
the deploy path gives them) at 4 decode rows and a 32-row chunk. For each
row count it prints:

* ``[bmm]``: the expert products of ``moe._expert_ffn`` over all 8
  experts against the same products over each rank's 4 experts (rows
  [0, 4) and [4, 8) of the dispatch buffer, the buffer an expert-parallel
  rank builds): how many elements differ and the largest difference over
  max |product|, for the ``w_gate``, ``w_up`` and ``w_out`` products;
* ``[block]``: the unsharded block (``moe.moe_apply``) against the sum in
  f32 of the two ranks' outputs computed in this one process (the
  arithmetic of ``moe.moe_apply_sharded`` without the collective), as
  max |difference| / max|out|;
* ``[block-8]``: the same sum with each rank's expert products taken from
  the 8-expert call's rows. 0.0 there means the whole gap of ``[block]``
  is the batched matmul's rounding at 4 experts against 8.

``--cpu`` runs the reduced config's block on the CPU (a rehearsal).
"""
from __future__ import annotations

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO))


def _gap(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _products(p, buf, mcfg):
    """(gate, up, out) of ``moe._expert_ffn`` on ``buf`` (E, C, D)."""
    import torch
    from repro_torch.models.common import ACTIVATIONS
    dt = torch.promote_types(buf.dtype, p["w_gate"].dtype)
    b = buf.to(dt)
    g = torch.bmm(b, p["w_gate"].to(dt))
    u = torch.bmm(b, p["w_up"].to(dt))
    out = torch.bmm(ACTIVATIONS[mcfg.activation](g) * u, p["w_out"].to(dt))
    return g, u, out


def _rank_params(p, r, half):
    return {"router": p["router"],
            **{k: p[k][r * half:(r + 1) * half]
               for k in ("w_gate", "w_up", "w_out")}}


def _rank_out(p, x, mcfg, r, top_p, top_e, capacity):
    """One of two expert-parallel ranks' output: ``moe_apply_sharded``'s
    body on its E/2 experts before the sum over ranks."""
    import torch
    from repro_torch.models import moe
    half = mcfg.num_experts // 2
    e_lo = r * half
    order, slot, keep, tok = moe._dispatch_indices(
        top_e, mcfg.num_experts, capacity, 0, mcfg.num_experts)
    sorted_e = top_e.reshape(-1).long()[order]
    local = (sorted_e >= e_lo) & (sorted_e < e_lo + half) & keep
    local_slot = torch.where(local, (sorted_e - e_lo) * capacity
                             + slot % capacity,
                             torch.full_like(slot, half * capacity))
    return moe._compute_combine(_rank_params(p, r, half), x, top_p, order,
                                local_slot, local, tok, half, capacity, mcfg)


def probe(dev, reduced=False):
    import torch
    import chip_smoke
    from repro_torch.models import moe
    p, mcfg, xs = chip_smoke.grok_block(dev, reduced=reduced)
    half = mcfg.num_experts // 2
    for t, x in xs.items():
        capacity = moe._capacity(t, mcfg)
        _, top_p, top_e = moe.router_probs(p, x, mcfg)
        order, slot, keep, tok = moe._dispatch_indices(
            top_e, mcfg.num_experts, capacity)
        d = x.shape[1]
        buf = torch.zeros((mcfg.num_experts * capacity + 1, d),
                          dtype=x.dtype, device=dev)
        buf[slot] = x[tok] * keep[:, None].to(x.dtype)
        buf = buf[:-1].reshape(mcfg.num_experts, capacity, d)
        whole = _products(p, buf, mcfg)
        halves = [_products(_rank_params(p, r, half),
                            buf[r * half:(r + 1) * half], mcfg)
                  for r in (0, 1)]
        for name, w, h0, h1 in zip(("w_gate", "w_up", "w_out"), whole,
                                   *halves):
            h = torch.cat([h0, h1])
            n = int((h != w).sum())
            print(f"[bmm] {t} rows (capacity {capacity}): {name} product "
                  f"{tuple(w.shape)}, {half}-expert calls against the "
                  f"{2 * half}-expert call: {n} of {w.numel()} elements "
                  f"differ, max |difference| / max|product| "
                  f"{_gap(h, w):.3e}")
        un = moe.moe_apply(p, x, mcfg)
        parts = [_rank_out(p, x, mcfg, r, top_p, top_e, capacity)
                 for r in (0, 1)]
        summed = (parts[0].float() + parts[1].float()).to(x.dtype)
        print(f"[block] {t} rows: unsharded against the two ranks' outputs "
              f"summed in f32: max |difference| / max|out| "
              f"{_gap(summed, un):.3e}")
        real = moe._expert_ffn
        full_out = whole[2]
        calls = []

        def rows_of_whole(q, b, c):
            r = len(calls)
            calls.append(r)
            return full_out[r * half:(r + 1) * half]
        moe._expert_ffn = rows_of_whole
        try:
            parts = [_rank_out(p, x, mcfg, r, top_p, top_e, capacity)
                     for r in (0, 1)]
        finally:
            moe._expert_ffn = real
        summed = (parts[0].float() + parts[1].float()).to(x.dtype)
        print(f"[block-8] {t} rows: the same with each rank's expert "
              f"products taken from the whole call's rows: max "
              f"|difference| / max|out| {_gap(summed, un):.3e}")
        del whole, halves, buf


def main(argv=None):
    import subprocess
    import torch
    argv = sys.argv[1:] if argv is None else argv
    cpu = "--cpu" in argv
    if cpu:
        probe(torch.device("cpu"), reduced=True)
        return 0
    if not torch.cuda.is_available():
        print("grok_bmm_probe: no CUDA device (pass --cpu to rehearse)",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(f"[device] {smi.stdout.strip()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    with torch.no_grad():
        probe(torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
