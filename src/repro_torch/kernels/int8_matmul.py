"""s8 x s8 -> s32 matmuls with the fused deployment epilogue (paper eq. 3-5).

Two functions, each as a Hopper kernel (``*_cuda``, ``csrc/int8_matmul.cu``)
and a plain PyTorch version (``*_plain``) that repeats the kernel's
arithmetic — integer products as an exact float64 matmul cast to int32,
one int32 partial per PEG group, and the same float order in the
epilogue:

* ``int8_matmul`` (port of ``repro.kernels.int8_matmul.int8_matmul``):
  ``f = (f32(A @ W) - z_a * colsum) * (s_a * s_w)``;
* ``int8_matmul_peg`` (port of ``...int8_matmul_peg``): for each group g of
  K/G contiguous columns, ``acc += s_g * (f32(A_g @ W_g) - z_g * colsum_g)``
  in group order, then ``f = acc * s_w``.

Both then run the shared epilogue: ``+ bias`` -> activation -> ``* mul`` ->
optional int8 requant ``clip(rint(f / s_out) + z_out, qmin, qmax)``.
``a_q`` is ``(M, K)`` int8, ``w_q`` ``(K, N)`` int8 or, with ``w_bits=4``,
``(K/2, N)`` pairwise-row nibbles (``kernels.nibble.pack_rows``): the plain
versions unpack them first, the kernel while it stores each W tile, and the
integer products are the same. Every scale and zero-point is a runtime
tensor (or number), never a compile-time constant. Each wrapper counts its
8-bit launches in ``launches`` and its 4-bit ones in ``launches_w4``.

``int8_matmul_cuda`` splits K across the blocks of a thread-block cluster
(:func:`plan_k_splits`), which sum their int32 partials in each other's
shared memory: a call is one launch and needs no scratch.
``int8_matmul_peg_cuda`` runs the same mainloop split by PEG group spans
(:func:`plan_peg_splits`): no run crosses a group, each group's int32
partial is summed over its runs exactly, and the reducing block folds the
groups in group order, so the float order is that of one block walking
all of K group by group.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _args, _build
from repro_torch.kernels.nibble import unpack_rows

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
SMS = 132           # streaming multiprocessors of an H100 SXM
K_TILE = 64         # depth of the kernel's K tiles (and of a split's unit)
MAX_K_SPLITS = 16   # Hopper's largest thread-block cluster
PEG_BLOCKS_PER_SM = 3   # PEG kernel blocks a multiprocessor holds (smem)


def _gelu(x):
    # jax.nn.gelu(approximate=True), operation for operation
    return x * (0.5 * (1.0 + torch.tanh(_SQRT_2_OVER_PI *
                                        (x + 0.044715 * (x * x * x)))))


def _silu(x):
    return x * (1.0 / (1.0 + torch.exp(-x)))


# Epilogue activations: identity plus the model table (models.common
# re-exports these so the simulate and deploy paths share one definition).
EPILOGUE_ACTS = {"none": lambda x: x, "gelu": _gelu, "silu": _silu,
                 "relu": torch.relu}
_ACT_CODE = {"none": 0, "gelu": 1, "silu": 2, "relu": 3}


def _weights(w_q, w_bits):
    """The int8 (K, N) weight values of an 8-bit or a 4-bit payload."""
    if w_bits == 4:
        return unpack_rows(w_q)
    if w_bits != 8:
        raise ValueError(f"int8 matmul: w_bits must be 4 or 8, got {w_bits}")
    return w_q


def _scalar(v, device):
    return torch.as_tensor(v, dtype=torch.float32, device=device).reshape(())


def epilogue(f, *, bias=None, activation="none", mul=None, out_scale=None,
             out_zp=None, qmin=-128, qmax=127):
    """The fused epilogue's float order: bias -> act -> mul -> requant."""
    if bias is not None:
        f = f + bias.float()[None, :]
    f = EPILOGUE_ACTS[activation](f)
    if mul is not None:
        f = f * mul.float()
    if out_scale is not None:
        zp = 0.0 if out_zp is None else _scalar(out_zp, f.device)
        q = torch.round(f / _scalar(out_scale, f.device)) + zp
        return torch.clamp(q, qmin, qmax).to(torch.int8)
    return f


def _int_matmul(a_q, w_q):
    """Exact int32 A @ W (every partial sum is an integer below 2^53)."""
    return (a_q.double() @ w_q.double()).to(torch.int32)


def int8_matmul_plain(a_q, w_q, s_a, s_w, *, z_a=None, w_colsum=None,
                      bias=None, mul=None, activation="none", out_scale=None,
                      out_zp=None, qmin=-128, qmax=127, w_bits=8):
    w_q = _weights(w_q, w_bits)
    dev = a_q.device
    s_prod = _scalar(s_a, dev) * _scalar(s_w, dev)
    acc = _int_matmul(a_q, w_q).float()
    if w_colsum is not None:
        za = _scalar(0.0 if z_a is None else z_a, dev)
        acc = acc - za * w_colsum.reshape(-1).float()[None, :]
    return epilogue(acc * s_prod, bias=bias, activation=activation, mul=mul,
                    out_scale=out_scale, out_zp=out_zp, qmin=qmin, qmax=qmax)


def int8_matmul_peg_plain(a_q, w_q, act_scales, act_zps, w_scale, w_colsum,
                          *, bias=None, mul=None, activation="none",
                          out_scale=None, out_zp=None, qmin=-128, qmax=127,
                          w_bits=8):
    w_q = _weights(w_q, w_bits)
    dev = a_q.device
    k = a_q.shape[1]
    s = _args.f32(act_scales, dev)
    z = _args.f32(act_zps, dev)
    g = s.numel()
    gs = k // g
    acc = torch.zeros((a_q.shape[0], w_q.shape[1]), dtype=torch.float32,
                      device=dev)
    for i in range(g):
        part = _int_matmul(a_q[:, i * gs:(i + 1) * gs],
                           w_q[i * gs:(i + 1) * gs]).float()
        acc = acc + s[i] * (part - z[i] * w_colsum[i].float()[None, :])
    return epilogue(acc * _scalar(w_scale, dev), bias=bias,
                    activation=activation, mul=mul, out_scale=out_scale,
                    out_zp=out_zp, qmin=qmin, qmax=qmax)


def plan_k_splits(m, n, k):
    """(row tile, column tile, K splits) of the split-K kernel for an
    (m, k) x (k, n) product: 16 x 128 output tiles for decode rows (m <=
    16), else 64 x 64; as many splits as fill the card about twice
    (2 * ``SMS`` blocks), but at most 16 (the splits of a tile form one
    cluster) and every split keeps at least two K tiles; rounded down to a
    power of two (clusters of 9 or 12 blocks measured slower than 8 on the
    H100)."""
    bm, bn = (16, 128) if m <= 16 else (64, 64)
    tiles = max(1, -(-m // bm) * -(-n // bn))
    k_tiles = -(-k // K_TILE)
    cap = max(1, min(-(-2 * SMS // tiles), MAX_K_SPLITS, k_tiles // 2))
    splits = 1 << (cap.bit_length() - 1)
    return bm, bn, splits


def k_split_tiles(k, splits):
    """The [first, end) K tiles of each split, as the kernel cuts them:
    split j owns tiles j * kt // S .. (j + 1) * kt // S."""
    kt = -(-k // K_TILE)
    return [(j * kt // splits, (j + 1) * kt // splits)
            for j in range(splits)]


def plan_peg_splits(m, n, k, groups):
    """(row tile, column tile, runs per group, groups per cluster) of the
    PEG kernel for an (m, k) x (k, n) product with ``groups`` PEG groups of
    k / groups columns: the tiles of :func:`plan_k_splits`; each group cut
    into the same number of runs of whole K tiles (a power of two), as many
    as fill the card about twice (2 * ``SMS`` blocks), but every run keeps
    at least two K tiles where its group has them and a tile's runs fit one
    cluster (at most 16 blocks). A cluster holds the runs of as many groups
    as keep the grid within the blocks the card holds at once
    (``PEG_BLOCKS_PER_SM`` a multiprocessor), at most 16 blocks; it walks
    the groups in equal rounds of that many."""
    bm, bn = (16, 128) if m <= 16 else (64, 64)
    tiles = max(1, -(-m // bm) * -(-n // bn))
    group_tiles = -(-(k // groups) // K_TILE)
    per_cluster = min(groups, MAX_K_SPLITS)
    want = -(-2 * SMS // tiles) // per_cluster
    cap = max(1, min(want, MAX_K_SPLITS // per_cluster, group_tiles // 2))
    runs = 1 << (cap.bit_length() - 1)
    fits = max(1, PEG_BLOCKS_PER_SM * SMS // (tiles * runs))
    rounds = -(-groups // min(groups, MAX_K_SPLITS // runs, fits))
    return bm, bn, runs, -(-groups // rounds)


def peg_split_runs(k, groups, runs, per_cluster):
    """The rounds of the PEG kernel, as it cuts them: per round, the
    (cluster rank, group, first K tile, end K tile) of every block that has
    work, tiles counted from the group's start (a group's last tile is
    masked at the group's end)."""
    kt = -(-(k // groups) // K_TILE)
    rounds = []
    for g0 in range(0, groups, per_cluster):
        rounds.append([(rank, g0 + rank // runs,
                        (rank % runs) * kt // runs,
                        (rank % runs + 1) * kt // runs)
                       for rank in range(runs * per_cluster)
                       if g0 + rank // runs < groups])
    return rounds


def _launch(a_q, w_q, colsum, a_scales, a_zps, w_scale, *, bias, mul,
            activation, out_scale, out_zp, qmin, qmax, peg, w_bits):
    if a_q.dim() != 2 or w_q.dim() != 2 or a_q.dtype != torch.int8 \
            or w_q.dtype != torch.int8:
        raise ValueError("int8 matmul: a_q (M, K) and w_q (K, N) must be "
                         "int8 matrices")
    if w_bits not in (4, 8):
        raise ValueError(f"int8 matmul: w_bits must be 4 or 8, got {w_bits}")
    m, k = a_q.shape
    k2, n = w_q.shape
    if k != (2 * k2 if w_bits == 4 else k2):
        raise ValueError(f"int8 matmul: K={k} does not match {k2} "
                         f"{'packed ' if w_bits == 4 else ''}weight rows")
    if activation not in _ACT_CODE:
        raise ValueError(f"unknown epilogue activation {activation!r}")
    _args.on_cuda(a_q, w_q, colsum, bias, mul)
    dev = a_q.device
    a_q, w_q = a_q.contiguous(), w_q.contiguous()
    g = a_scales.numel()
    if k % g or (w_bits == 4 and (k // g) % 2):
        raise ValueError(f"int8 matmul: {g} groups do not divide K={k} "
                         f"into {'even ' if w_bits == 4 else ''}spans")
    if colsum is not None:
        colsum = colsum.to(torch.int32).contiguous()
        if colsum.numel() != g * n:
            raise ValueError(f"int8 matmul: colsum has {colsum.numel()} "
                             f"values, expected {g}x{n}")
    if bias is not None:
        bias = _args.f32(bias, dev, n, "bias")
    if mul is not None:
        if tuple(mul.shape) != (m, n):
            raise ValueError(f"int8 matmul: mul must be ({m}, {n}), got "
                             f"{tuple(mul.shape)}")
        mul = mul.float().contiguous()
    requant = out_scale is not None
    s_o = _args.f32(out_scale, dev, 1, "out_scale") if requant else None
    z_o = (_args.f32(0.0 if out_zp is None else out_zp, dev, 1, "out_zp")
           if requant else None)
    out = torch.empty((m, n), dtype=torch.int8 if requant else torch.float32,
                      device=dev)
    vec_a = int(k % 16 == 0 and (k // g) % 16 == 0
                and a_q.data_ptr() % 16 == 0)
    vec_w = int(n % 16 == 0 and w_q.data_ptr() % 16 == 0)
    if peg:
        bm, _, splits, per_cluster = plan_peg_splits(m, n, k, g)
    else:
        (bm, _, splits), per_cluster = plan_k_splits(m, n, k), 0
    _build.check(_build.lib("int8_matmul").int8_matmul(
        a_q.data_ptr(), w_q.data_ptr(), _args.ptr(colsum),
        a_scales.data_ptr(), _args.ptr(a_zps), w_scale.data_ptr(),
        _args.ptr(bias), _args.ptr(mul), _args.ptr(s_o), _args.ptr(z_o),
        out.data_ptr(), m, n, k, g, int(peg), _ACT_CODE[activation], qmin,
        qmax, vec_a, vec_w, w_bits, bm, splits, per_cluster, _args.stream()),
        "int8_matmul_peg" if peg else "int8_matmul")
    return out


def int8_matmul_cuda(a_q, w_q, s_a, s_w, *, z_a=None, w_colsum=None,
                     bias=None, mul=None, activation="none", out_scale=None,
                     out_zp=None, qmin=-128, qmax=127, w_bits=8):
    dev = a_q.device
    if z_a is not None and w_colsum is None:
        raise ValueError("int8_matmul: z_a requires w_colsum")
    out = _launch(a_q, w_q, w_colsum, _args.f32(s_a, dev, 1, "s_a"),
                  None if z_a is None else _args.f32(z_a, dev, 1, "z_a"),
                  _args.f32(s_w, dev, 1, "s_w"), bias=bias, mul=mul,
                  activation=activation, out_scale=out_scale, out_zp=out_zp,
                  qmin=qmin, qmax=qmax, peg=False, w_bits=w_bits)
    if w_bits == 4:
        int8_matmul_cuda.launches_w4 += 1
    else:
        int8_matmul_cuda.launches += 1
    return out


def int8_matmul_peg_cuda(a_q, w_q, act_scales, act_zps, w_scale, w_colsum,
                         *, bias=None, mul=None, activation="none",
                         out_scale=None, out_zp=None, qmin=-128, qmax=127,
                         w_bits=8):
    dev = a_q.device
    s = _args.f32(act_scales, dev, what="act_scales")
    out = _launch(a_q, w_q, w_colsum, s,
                  _args.f32(act_zps, dev, s.numel(), "act_zps"),
                  _args.f32(w_scale, dev, 1, "w_scale"), bias=bias, mul=mul,
                  activation=activation, out_scale=out_scale, out_zp=out_zp,
                  qmin=qmin, qmax=qmax, peg=True, w_bits=w_bits)
    if w_bits == 4:
        int8_matmul_peg_cuda.launches_w4 += 1
    else:
        int8_matmul_peg_cuda.launches += 1
    return out


int8_matmul_cuda.launches = int8_matmul_cuda.launches_w4 = 0
int8_matmul_peg_cuda.launches = int8_matmul_peg_cuda.launches_w4 = 0
