"""Per-embedding-group (PEG) quantization, the paper's scheme (§4): K
evenly-sized groups of embedding dims, optionally following the range-based
permutation ``argsort(range)`` so the outlier dims share one group (port of
``repro.core.peg``; host-side numpy).

The group sizes keep the reference's LANE = 128 alignment: the groups decide
the quantization grids, so the port must build the same ones. For d = 2304
and K = 4 they come out as [640, 640, 512, 512] — non-uniform, which the
integer kernels cannot express, so that site serves on the fake-quant path
(see ``core.deploy.act_quant_for``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

LANE = 128  # the reference's TPU lane width, kept: it decides the groups


class PEGSpec(NamedTuple):
    """Static grouping decision for one activation site (host-side)."""
    permutation: np.ndarray        # (d,) dim order: position -> original dim
    inverse_permutation: np.ndarray
    group_index: np.ndarray        # (d,) group id *in permuted layout*
    num_groups: int
    group_sizes: np.ndarray        # (K,)


def _even_group_sizes(d: int, k: int, lane_align: bool) -> np.ndarray:
    """K near-even group sizes summing to d; multiples of LANE if possible."""
    if lane_align and d % LANE == 0 and (d // LANE) >= k:
        units = d // LANE
        base = units // k
        rem = units % k
        sizes = np.full(k, base, dtype=np.int64)
        sizes[:rem] += 1
        return sizes * LANE
    base = d // k
    rem = d % k
    sizes = np.full(k, base, dtype=np.int64)
    sizes[:rem] += 1
    return sizes


def build_groups(ranges: np.ndarray, num_groups: int, *,
                 use_permutation: bool = True,
                 lane_align: bool = True,
                 tp_shards: int = 1) -> PEGSpec:
    """Build the PEG spec from calibrated per-dim dynamic ranges.

    ranges: (d,) non-negative per-embedding-dim dynamic range (max - min).
    tp_shards: if >1, dims are partitioned into `tp_shards` contiguous shards
      and the permutation only reorders within each shard; num_groups must be
      divisible by tp_shards (K_per_shard groups each).
    """
    ranges = np.asarray(ranges, dtype=np.float64)
    d = ranges.shape[0]
    if num_groups < 1 or num_groups > d:
        raise ValueError(f"num_groups={num_groups} out of range for d={d}")
    if d % tp_shards != 0:
        raise ValueError(f"d={d} not divisible by tp_shards={tp_shards}")
    if num_groups % tp_shards != 0:
        raise ValueError(f"num_groups={num_groups} not divisible by "
                         f"tp_shards={tp_shards}")

    if tp_shards > 1:
        per = d // tp_shards
        k_per = num_groups // tp_shards
        perms, gidx, sizes = [], [], []
        for s in range(tp_shards):
            sub = build_groups(ranges[s * per:(s + 1) * per], k_per,
                               use_permutation=use_permutation,
                               lane_align=lane_align, tp_shards=1)
            perms.append(sub.permutation + s * per)
            gidx.append(sub.group_index + s * k_per)
            sizes.append(sub.group_sizes)
        perm = np.concatenate(perms)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(d)
        return PEGSpec(permutation=perm, inverse_permutation=inv,
                       group_index=np.concatenate(gidx),
                       num_groups=num_groups,
                       group_sizes=np.concatenate(sizes))

    if use_permutation:
        # Deterministic range-based permutation (paper §4): ascending range,
        # stable, so the largest-range (outlier) dims share the last group.
        perm = np.argsort(ranges, kind="stable")
    else:
        perm = np.arange(d)
    sizes = _even_group_sizes(d, num_groups, lane_align)
    group_index = np.repeat(np.arange(num_groups), sizes)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(d)
    return PEGSpec(permutation=perm.astype(np.int64),
                   inverse_permutation=inv.astype(np.int64),
                   group_index=group_index.astype(np.int64),
                   num_groups=num_groups,
                   group_sizes=sizes)


def group_index_natural_layout(spec: PEGSpec) -> np.ndarray:
    """Group id per *original* (un-permuted) dim — for runtime fake-quant when
    the permutation is NOT folded into the weights."""
    return spec.group_index[spec.inverse_permutation]
