#!/usr/bin/env python3
"""The port against the reference (JAX) on the CPU, where the two part by
more than rounding would suggest: the gaps behind the tolerances of
``tests/test_torch_variants.py`` and of the recurrent cases of
``tests/test_torch_train.py``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/variants_gaps.py

Prints three groups of lines:

* ``[int8-storage]``: reduced internlm2-20b with every stacked attention
  and FFN weight of width >= 64 stored as int8, the port's logits against
  the reference's (max |difference| / max |reference|), with the stored
  weight dequantized in the matmul's type (the port's ``resolve_weight``)
  and in bf16 (the reference's code as written);
* ``[round-trip]``: the reference test's round-trip bound (half a scale
  plus 2^-8 of the column's largest magnitude) on a numpy input, for both
  packages;
* ``[rwkv6-grads]``: reduced rwkv6-1p6b's ``train_loss`` gradients at B 4
  x T 32 (the jitted-step test's batch), each leaf's max |difference| /
  max |reference| for the port against the reference, the two packages
  against each other in float64 (every float32 of both widened,
  ``tests/test_torch_recurrent.py::in_float64``), and both float32 runs
  against the reference's float64 one; then the grad norms' gaps to the
  float64 norm. (``jax.enable_x64`` alone is no oracle: the chunked WKV
  casts to float32 inside it.)
"""
from __future__ import annotations

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO / "tests"))


def _rel(got, want):
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def int8_storage():
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from repro.configs import get_config as jget_config
    from repro.models import transformer as jtfm
    from repro.models.common import quantize_weight_int8 as jquantize
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.models import attention, ffn
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import (quantize_stacked_int8,
                                           resolve_weight)

    def stored(params, fn):
        out = dict(params, scan=[])
        for g in params["scan"]:
            g = dict(g)
            for blk in ("attn", "ffn"):
                g[blk] = {n: fn(w) if w.ndim == 3 and w.shape[-1] >= 64
                          else w for n, w in g[blk].items()}
            out["scan"].append(g)
        return out
    jcfg = jget_config("internlm2-20b").reduced()
    cfg = get_config("internlm2-20b").reduced()
    jp = jtfm.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 12))
    want = jtfm.forward(jcfg, stored(jp, jax.vmap(jquantize)),
                        jnp.asarray(toks))[0]
    tpq = stored(tp, quantize_stacked_int8)
    for label, dtype in (("the matmul's type", None),
                         ("bf16", torch.bfloat16)):
        saved = attention.resolve_weight, ffn.resolve_weight
        if dtype is not None:
            def fixed(w, _dtype=None):
                return resolve_weight(w, dtype)
            attention.resolve_weight = ffn.resolve_weight = fixed
        try:
            with torch.no_grad():
                got = tfm.forward(cfg, tpq, torch.as_tensor(toks))[0]
        finally:
            attention.resolve_weight, ffn.resolve_weight = saved
        print(f"[int8-storage] dequantized in {label}: port vs reference "
              f"logits {_rel(got.numpy(), want):.3e} of max|logits|")


def round_trip():
    import jax.numpy as jnp
    import numpy as np
    import torch
    from repro.models.common import quantize_weight_int8 as jquantize
    from repro.models.common import resolve_weight as jresolve
    from repro_torch.models.common import (quantize_weight_int8,
                                           resolve_weight)
    w = (np.random.RandomState(0).randn(128, 64) / 8).astype(np.float32)
    amax = np.abs(w).max(axis=0)
    for label, deq, s in (
            ("port", lambda: resolve_weight(quantize_weight_int8(
                torch.from_numpy(w))).float().numpy(),
             lambda: quantize_weight_int8(torch.from_numpy(w))["s"].numpy()),
            ("reference", lambda: np.asarray(
                jresolve(jquantize(jnp.asarray(w))), np.float32),
             lambda: np.asarray(jquantize(jnp.asarray(w))["s"]))):
        err = np.abs(w - deq())
        bound = s()[0] * 0.51 + amax * 2.0 ** -8 + 1e-4
        i = tuple(int(v) for v in np.unravel_index(
            np.argmax(err - bound[None, :]), err.shape))
        print(f"[round-trip] {label}: worst element {i}: error "
              f"{err[i]:.6g} against the bound {bound[i[1]]:.6g}")


def rwkv6_grads():
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from repro.configs import get_config as jget_config
    from repro.models import transformer as jtfm
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import tree_leaves, value_and_grad
    from test_torch_recurrent import in_float64
    jcfg = jget_config("rwkv6-1p6b").reduced()
    cfg = get_config("rwkv6-1p6b").reduced()
    jp = jtfm.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    toks = np.random.RandomState(6).randint(0, jcfg.vocab_size,
                                            size=(4, 32)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    g32 = jax.jit(jax.grad(lambda p: jtfm.train_loss(jcfg, p, jb)))(jp)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    _, gp = value_and_grad(lambda p: tfm.train_loss(cfg, p, tb), tp)
    with in_float64():
        j64 = jax.jit(jax.grad(lambda p: jtfm.train_loss(jcfg, p, jb)))(
            jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), jp))
        _, t64 = value_and_grad(
            lambda p: tfm.train_loss(cfg, p, tb),
            params_from_jax(jax.tree.map(
                lambda x: np.asarray(x, np.float64), jp), device="cpu"))
    paths = [jax.tree_util.keystr(k)
             for k, _ in jax.tree_util.tree_leaves_with_path(g32)]
    worst = [0.0] * 4
    sq = np.zeros(3)
    for path, a, r, o, ot in zip(paths, tree_leaves(gp), jax.tree.leaves(g32),
                                 jax.tree.leaves(j64), tree_leaves(t64)):
        a = a.detach().numpy()
        gaps = (_rel(a, r), _rel(ot.numpy(), o), _rel(a, o), _rel(r, o))
        worst = [max(w, g) for w, g in zip(worst, gaps)]
        sq += [float((np.asarray(x, np.float64) ** 2).sum())
               for x in (a, r, o)]
        print(f"[rwkv6-grads] {path}: port vs reference {gaps[0]:.3e}; "
              f"in float64 {gaps[1]:.3e}; against the float64 run: port "
              f"{gaps[2]:.3e}, reference {gaps[3]:.3e}")
    norm = np.sqrt(sq)
    print(f"[rwkv6-grads] largest (of each leaf's largest magnitude): port "
          f"vs reference {worst[0]:.3e}; the two in float64 {worst[1]:.3e}; "
          f"against the float64 run: port {worst[2]:.3e}, reference "
          f"{worst[3]:.3e}")
    print(f"[rwkv6-grads] grad norm {norm[2]:.10g} in float64; port "
          f"{(norm[0] - norm[2]) / norm[2]:+.3e}, reference "
          f"{(norm[1] - norm[2]) / norm[2]:+.3e} from it")


def main():
    import torch
    torch.set_num_threads(4)
    int8_storage()
    round_trip()
    rwkv6_grads()


if __name__ == "__main__":
    main()
