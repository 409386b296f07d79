"""Divisibility-aware sharding rules (port of ``repro.parallel.sharding``).

Axes: ``pod`` (cross-pod DP), ``data`` (in-pod DP + FSDP for params),
``model`` (TP for heads / FFN hidden / vocab, EP for experts, SP for
long-context caches). Every rule degrades gracefully: a dimension is
sharded on an axis only if it divides evenly, otherwise that dim is
replicated.

A spec is a tuple with one entry per dim: an axis name, a tuple of axis
names, or None, trailing Nones trimmed and one-name tuples written as the
name, so it compares equal to ``tuple(PartitionSpec)`` of the reference.
The rules read only the mesh's axis sizes (``launch.mesh.AbstractMesh``).

Placing a tree on a :class:`~repro_torch.launch.mesh.RankMesh` keeps, on
each rank, the slice of every leaf that its spec assigns to that rank
(:func:`place`, :func:`make_param_shardings`); a leaf whose spec names no
axis of size > 1 stays the same tensor. :func:`cache_spec_for`,
:func:`make_cache_specs` and :func:`make_cache_shardings` are the
reference's rule, both branches. Serving executes two cache layouts
(:func:`place_cache`): the reference's default, every KV cache on its
sequence dim (``kv_seq_shard=True``, :func:`make_seq_cache_shardings`:
the specs of :func:`make_cache_specs`, the block table whole), and the
KV-head layout (``kv_seq_shard=False``, :func:`make_kv_head_shardings`).

Training keeps a tree of :class:`NamedSharding` leaves beside the placed
params and optimizer state (the reference's NamedSharding trees):
:func:`param_shardings` from the logical (whole) shapes of the config's
params, :func:`make_opt_shardings` / ``optim.quantized_adam.
qadam_shardings`` mirroring them, :func:`gather_leaf` and :func:`cut_leaf`
between a rank's slices and the logical arrays
(``checkpoint.Checkpointer``).
"""
from __future__ import annotations

import dataclasses
import functools
import math
import re
from typing import Any, Optional, Tuple

import torch

from repro_torch.models.transformer import DistContext

Spec = Tuple[Any, ...]


def make_abstract_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]):
    """Device-free mesh for sharding-rule logic."""
    from repro_torch.launch.mesh import AbstractMesh
    return AbstractMesh(shape, axes)


def make_dist(mesh) -> DistContext:
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    # FSDP spans the whole data-parallel group (pod, data) on the
    # multi-pod mesh
    fsdp = dp if len(dp) > 1 else "data"
    return DistContext(mesh=mesh, tp_axis="model", fsdp_axis=fsdp,
                       dp_axes=dp)


def _axis_size(mesh, axis) -> int:
    if isinstance(axis, tuple):
        return math.prod(mesh.shape[a] for a in axis)
    return mesh.shape[axis]


def _fits(dim: int, mesh, axis) -> bool:
    if axis is None:
        return True
    return dim % _axis_size(mesh, axis) == 0


def _finish(cleaned) -> Spec:
    """Trim trailing Nones and write one-name tuples as the name (the
    reference's PartitionSpec does both)."""
    out = [a[0] if isinstance(a, tuple) and len(a) == 1 else a
           for a in cleaned]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _spec(mesh, shape, assignment) -> Spec:
    """assignment: axis name / tuple / None per dim; drop non-divisible or
    already-used axes."""
    cleaned = []
    used = set()
    for dim, axis in zip(shape, assignment):
        names = axis if isinstance(axis, tuple) else (axis,)
        if axis is not None and not (set(names) & used) and \
                _fits(dim, mesh, axis):
            cleaned.append(axis)
            used.update(names)
        else:
            cleaned.append(None)
    return _finish(cleaned)


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------

# name-pattern -> per-dim axis assignment for the TRAILING dims (the leading
# scan/stack dim, when present, is never sharded). "tp"/"fsdp" resolve to
# model/data.
_PARAM_RULES = [
    # attention projections
    (r".*attn.*wq$", ("fsdp", "tp")),
    (r".*attn.*wk$", ("fsdp", "tp")),
    (r".*attn.*wv$", ("fsdp", "tp")),
    (r".*attn.*wo$", ("tp", "fsdp")),
    (r".*(xattn).*w[qkv]$", ("fsdp", "tp")),
    (r".*(xattn).*wo$", ("tp", "fsdp")),
    # dense FFN
    (r".*ffn.*(w_gate|w_up|w_in)$", ("fsdp", "tp")),
    (r".*ffn.*w_out$", ("tp", "fsdp")),
    # MoE experts (params keyed "moe"): (E, D, F) / (E, F, D)
    (r".*moe.*(w_gate|w_up)$", ("tp", "fsdp", None)),
    (r".*moe.*w_out$", ("tp", None, "fsdp")),
    (r".*moe.*router$", ("fsdp", None)),
    # RG-LRU
    (r".*rec.*(w_rnn_in|w_gate_in)$", ("fsdp", "tp")),
    (r".*rec.*w_out$", ("tp", "fsdp")),
    (r".*rec.*(w_a|w_x)$", ("fsdp", "tp")),
    (r".*rec.*conv_w$", (None, "tp")),
    (r".*rec.*(b_a|b_x|conv_b|lam)$", ("tp",)),
    # RWKV
    (r".*tmix.*(w_r|w_k|w_v|w_g)$", ("fsdp", "tp")),
    (r".*tmix.*w_o$", ("tp", "fsdp")),
    (r".*tmix.*w_lora_a$", ("fsdp", None)),
    (r".*tmix.*w_lora_b$", (None, "tp")),
    (r".*cmix.*(w_ck|w_cr)$", ("fsdp", "tp")),
    (r".*cmix.*w_cv$", ("tp", "fsdp")),
    # embeddings / heads
    (r".*(embed|tok_embed)$", ("tp", "fsdp")),
    (r".*(enc_pos|dec_pos|pos_embed)$", (None, "fsdp")),
    (r".*lm_head$", ("fsdp", "tp")),
    (r".*(w_pool|w_cls)$", ("fsdp", None)),
]


def _resolve(axis: Optional[str], dist: DistContext):
    if axis == "tp":
        return dist.tp_axis
    if axis == "fsdp":
        return dist.fsdp_axis
    return axis


def param_spec_for(path: str, shape: Tuple[int, ...], dist: DistContext,
                   *, has_scan_dim: bool) -> Spec:
    mesh = dist.mesh
    # MoE expert tensors whose E dim does not divide TP (grok-1): fall back
    # to TP on the d_ff dim (the reference's hybrid mode)
    if re.search(r"moe.*(w_gate|w_up|w_out)$", path) and len(shape) >= 3:
        e_dim = shape[-3]
        if e_dim % mesh.shape[dist.tp_axis] != 0:
            if path.endswith("w_out"):     # (E, F, D): F on tp, D on fsdp
                assign = (None, dist.tp_axis, dist.fsdp_axis)
            else:                          # (E, D, F): D on fsdp, F on tp
                assign = (None, dist.fsdp_axis, dist.tp_axis)
            lead = len(shape) - 3
            return _spec(mesh, shape, (None,) * lead + assign)
    for pattern, assignment in _PARAM_RULES:
        if re.fullmatch(pattern, path):
            assign = tuple(_resolve(a, dist) for a in assignment)
            lead = len(shape) - len(assign)
            if lead < 0:          # rule for more dims than leaf has: replicate
                return ()
            return _spec(mesh, shape, (None,) * lead + assign)
    # default: replicate small leaves; fsdp-shard anything big on its largest
    # divisible dim
    if math.prod(shape) >= 1 << 20:
        best = max(range(len(shape)), key=lambda i: shape[i])
        assign = [None] * len(shape)
        if _fits(shape[best], mesh, dist.fsdp_axis):
            assign[best] = dist.fsdp_axis
        return _spec(mesh, shape, tuple(assign))
    return ()


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------

def tree_leaves_with_path(tree, prefix=()):
    """(path, leaf) of every tensor leaf of nested dicts / lists / tuples /
    NamedTuples in order, path entries written as the reference's
    ``_leaf_path`` writes jax's keys: dict keys and list indices as
    themselves, NamedTuple fields as ``.field``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves_with_path(v, prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from tree_leaves_with_path(v, prefix + (f".{k}",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_path(v, prefix + (str(i),))
    elif tree is not None:
        yield "/".join(prefix), tree


def _map_with_path(fn, tree, prefix=()):
    """``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, prefix + (f".{k}",))
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, prefix + (str(i),))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn("/".join(prefix), tree)


def _param_spec_of(dist: DistContext):
    return lambda path, leaf: param_spec_for(
        path, tuple(leaf.shape), dist, has_scan_dim="scan" in path)


def make_param_specs(params, dist: DistContext):
    """The tree of specs matching ``params``."""
    return _map_with_path(_param_spec_of(dist), params)


def place(tree, spec_of, mesh):
    """Each leaf of ``tree`` cut to this rank's slice under its spec
    (``spec_of(path, leaf)``): along every dim whose axes have size > 1,
    the block at this rank's index on them. A cut leaf is a fresh
    contiguous tensor, so the whole one can be freed; a leaf that is not
    cut is returned as it is."""
    def cut(path, x):
        was_cut = False
        for d, axis in enumerate(spec_of(path, x)):
            if axis is None or _axis_size(mesh, axis) == 1:
                continue
            size = x.shape[d] // _axis_size(mesh, axis)
            x = x.narrow(d, mesh.index(axis) * size, size)
            was_cut = True
        return x.clone(memory_format=torch.contiguous_format) if was_cut \
            else x
    return _map_with_path(cut, tree)


def make_param_shardings(params, dist: DistContext):
    """``params`` placed on ``dist.mesh`` (a rank mesh): every leaf cut to
    this rank's slice of :func:`make_param_specs`."""
    return place(params, _param_spec_of(dist), dist.mesh)


# ---------------------------------------------------------------------------
# Named shardings (training: params, optimizer state, checkpoints)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's placement: the mesh and the spec (the reference's
    ``jax.sharding.NamedSharding``; a leaf of sharding trees)."""
    mesh: Any
    spec: Spec


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def replication(sharding: NamedSharding) -> int:
    """How many ranks hold each element of a leaf placed by
    ``sharding``: the mesh size over the sizes of its sharded axes."""
    n = sharding.mesh.size
    for entry in sharding.spec:
        for a in _axes_of(entry):
            n //= sharding.mesh.shape[a]
    return n


@functools.lru_cache(maxsize=None)
def logical_params(cfg, stacked: bool = True):
    """The whole param tree of ``cfg`` on the meta device: the logical
    shapes that the rules place (no memory)."""
    from repro_torch.models import transformer as tfm
    return tfm.init_params(cfg, 0, stacked=stacked, dtype=torch.float32,
                           device="meta")


def param_shardings(cfg, params, dist: DistContext, stacked: bool = True):
    """The :class:`NamedSharding` tree of ``params``, this rank's slices of
    ``cfg``'s params as :func:`make_param_shardings` placed them: each
    leaf's spec is :func:`param_spec_for` of its logical (whole) shape.
    Raises where a leaf is not its slice of the logical tree. ``params``
    None: the tree of the logical params (``stacked`` or unrolled), on
    any mesh (an abstract one too)."""
    if params is None:
        params = logical_params(cfg, stacked)
        return _map_with_path(
            lambda path, w: NamedSharding(dist.mesh,
                                          _param_spec_of(dist)(path, w)),
            params)
    whole = dict(tree_leaves_with_path(logical_params(cfg,
                                                      "scan" in params)))
    spec_of = _param_spec_of(dist)
    mesh = dist.mesh

    def one(path, leaf):
        w = whole.get(path)
        if w is None:
            raise ValueError(f"{path} is not a leaf of {cfg.name}'s params")
        spec = spec_of(path, w)
        want = list(w.shape)
        for d, entry in enumerate(spec):
            for a in _axes_of(entry):
                want[d] //= mesh.shape[a]
        if tuple(leaf.shape) != tuple(want):
            raise ValueError(
                f"{path} is {tuple(leaf.shape)}, not this rank's slice "
                f"{tuple(want)} of {tuple(w.shape)}: place the params with "
                "parallel.sharding.make_param_shardings")
        return NamedSharding(mesh, spec)
    return _map_with_path(one, params)


def make_opt_shardings(opt_state, param_shardings, dist: DistContext):
    """The optimizer state's shardings: the moments mirror the params
    (``param_shardings``, a :class:`NamedSharding` tree), an 8-bit
    moment's payload as its param and its row scales without the last
    entry (``optim.quantized_adam.qadam_shardings``); the step counter
    replicated."""
    from repro_torch.optim.quantized_adam import qadam_shardings
    for_leaf = qadam_shardings(param_shardings)

    def mirror(sh, moment):
        if isinstance(sh, NamedSharding):
            if isinstance(moment, dict) and "q" in moment:
                return for_leaf(sh, moment["q"].dim())
            return sh
        if isinstance(sh, dict):
            return {k: mirror(sh[k], moment[k]) for k in sh}
        parts = [mirror(a, b) for a, b in zip(sh, moment)]
        return type(sh)(*parts) if hasattr(sh, "_fields") \
            else type(sh)(parts)
    return type(opt_state)(step=NamedSharding(dist.mesh, ()),
                           mu=mirror(param_shardings, opt_state.mu),
                           nu=mirror(param_shardings, opt_state.nu))


def gather_leaf(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """The logical (whole) leaf of this rank's slice ``x`` placed by
    ``sharding``: every sharded dim gathered over its axes, bit for bit.
    Every rank of the mesh must call it, in one order."""
    from repro_torch.parallel import collectives as coll
    dist = DistContext(mesh=sharding.mesh)
    for d, entry in enumerate(sharding.spec):
        if entry is not None:
            x = coll.all_gather(x, dist, d, entry)
    return x


def cut_leaf(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's slice of the logical leaf ``x`` under ``sharding``."""
    return place(x, lambda path, leaf: sharding.spec, sharding.mesh)


def gather_logical(tree, shardings):
    """The logical leaves of ``tree`` (this rank's slices) under
    ``shardings``, a :class:`NamedSharding` tree of the same structure
    (:func:`gather_leaf` on every leaf)."""
    flat = dict(tree_leaves_with_path(shardings))
    return _map_with_path(lambda path, x: gather_leaf(x, flat[path]), tree)


# ---------------------------------------------------------------------------
# Activation / batch / cache rules
# ---------------------------------------------------------------------------

def batch_spec(dist: DistContext) -> Spec:
    return _finish([dist.dp_axes])


def make_batch_shardings(batch, dist: DistContext):
    """Specs of a batch tree: the leading (batch) dim over dp where it
    divides, else replicated (``data.pipeline.shard_batch`` cuts a rank's
    rows by them)."""
    dp = math.prod(dist.mesh.shape[a] for a in dist.dp_axes)

    def spec(_, leaf):
        bs = leaf.shape[0] if leaf.dim() else 1
        if bs % dp == 0:
            return _finish([dist.dp_axes] + [None] * (leaf.dim() - 1))
        return ()
    return _map_with_path(spec, batch)


def cache_spec_for(shape: Tuple[int, ...], dist: DistContext,
                   *, has_scan_dim: bool) -> Spec:
    """The reference's KV cache / recurrent state rule. Layout (with scan
    dim): (L, B, S, KV, hd) or (L, B, ...state dims). B shards over dp when
    divisible, otherwise the sequence dim over ``data``. On ``model`` the
    SEQUENCE dim of 5-dim KV caches by default (``kv_seq_shard``), the
    head / feature dims otherwise or when S does not divide."""
    mesh = dist.mesh
    dp = math.prod(mesh.shape[a] for a in dist.dp_axes)
    lead = 1 if has_scan_dim else 0
    ndim = len(shape)
    assign = [None] * ndim
    bdim = lead
    if ndim <= bdim:
        return ()
    batch_shardable = shape[bdim] % dp == 0
    if batch_shardable:
        assign[bdim] = dist.dp_axes
    if ndim > bdim + 1:
        sdim = bdim + 1
        if not batch_shardable and \
                shape[sdim] % _axis_size(mesh, dist.fsdp_axis) == 0:
            assign[sdim] = dist.fsdp_axis          # SP over 'data'
    tp = mesh.shape[dist.tp_axis]
    tp_used = False
    if getattr(dist, "kv_seq_shard", True) and ndim - lead == 4:
        sdim = bdim + 1
        if assign[sdim] is None and shape[sdim] % tp == 0 \
                and shape[sdim] >= tp:
            assign[sdim] = dist.tp_axis
            tp_used = True
    if not tp_used:
        for d in range(ndim - 2, ndim):
            if d > bdim and assign[d] is None and shape[d] % tp == 0 and \
                    dist.tp_axis not in [a for a in assign if a]:
                # avoid sharding tiny dims (e.g. kv=1, hd=64 < tp)
                if shape[d] >= tp:
                    assign[d] = dist.tp_axis
                    break
    cleaned = []
    used = set()
    for dim, axis in zip(shape, assign):
        if axis is None:
            cleaned.append(None)
        elif isinstance(axis, tuple):
            cleaned.append(axis)
            used.update(axis)
        elif axis not in used:
            cleaned.append(axis)
            used.add(axis)
        else:
            cleaned.append(None)
    return _finish(cleaned)


def _cache_spec_of(dist: DistContext):
    def spec(path, leaf):
        has_scan = "scan" in path or "self_kv" in path or "cross" in path
        return cache_spec_for(tuple(leaf.shape), dist, has_scan_dim=has_scan)
    return spec


def make_cache_specs(cache, dist: DistContext):
    """The reference's spec tree of a cache: :func:`cache_spec_for` per
    leaf, the scan dim read from the leaf's path."""
    return _map_with_path(_cache_spec_of(dist), cache)


def make_cache_shardings(cache, dist: DistContext):
    """``cache`` placed on ``dist.mesh`` by :func:`make_cache_specs` (the
    reference's rule, every leaf, the block table's block dim too). With
    ``kv_seq_shard=False`` it cuts the payloads on their KV heads but the
    scales, positions and block table on their sequence or block dims,
    which the port does not execute: serving places caches with
    :func:`place_cache`."""
    return place(cache, _cache_spec_of(dist), dist.mesh)


def _seq_spec_of(dist: DistContext):
    ref = _cache_spec_of(dist)
    tp = dist.mesh.shape[dist.tp_axis]

    def spec(path, leaf):
        field = path.rsplit("/", 1)[-1]
        if field == "block_table":
            return ()       # host-written, whole on every rank
        if field not in _KV_HEAD_DIM and field != ".pos":
            raise NotImplementedError(
                f"cache field {path} is not yet ported under --tp / dist "
                "(KV caches only)")
        got = ref(path, leaf)
        sdim = 2 if "scan" in path else 1       # (L,) B, S, ...
        on_tp = [d for d, a in enumerate(got)
                 if dist.tp_axis in (a if isinstance(a, tuple) else (a,))]
        if on_tp != [sdim]:
            raise NotImplementedError(
                f"placing {path}'s {leaf.shape[sdim]} cells on {tp} ranks "
                f"(the reference's rule falls back to {got}) is not yet "
                "ported under --tp / dist")
        return got
    return spec


def make_seq_cache_specs(cache, dist: DistContext):
    """The placement the port's serving executes by default: the
    reference's :func:`make_cache_specs` for every KV cache field
    (payloads, per-(token, head) scales and positions on their sequence
    dim over ``model``: dense cells [r*S/N, (r+1)*S/N) on rank r, paged
    in-block cells [r*bs/N, (r+1)*bs/N) of every block), and the block
    table whole on every rank (the reference also cuts its block dim, a
    placement of storage only). Raises "... not yet ported" where the rule
    falls back off the sequence dim (S or bs not divided by N)."""
    return _map_with_path(_seq_spec_of(dist), cache)


def make_seq_cache_shardings(cache, dist: DistContext):
    """``cache`` placed on ``dist.mesh`` by :func:`make_seq_cache_specs`."""
    return place(cache, _seq_spec_of(dist), dist.mesh)


def place_cache(cache, dist: Optional[DistContext]):
    """``cache`` placed for serving under ``dist``'s layout: on the
    sequence dim (``kv_seq_shard``, the default) or on the KV heads; the
    cache itself without ``dist``."""
    if dist is None:
        return cache
    if dist.kv_seq_shard:
        return make_seq_cache_shardings(cache, dist)
    return make_kv_head_shardings(cache, dist)


# the KV-head dim of each cache field, counted from the end: payloads
# (..., KV, hd), per-(token, head) scales (..., KV); positions and the block
# table carry no head dim and stay whole on every rank
_KV_HEAD_DIM = {".k": -2, ".v": -2, ".k_q": -2, ".v_q": -2, ".k_s": -1,
                ".v_s": -1}


def _kv_head_spec_of(dist: DistContext):
    tp = dist.mesh.shape[dist.tp_axis]

    def spec(path, leaf):
        field = path.rsplit("/", 1)[-1]
        d = _KV_HEAD_DIM.get(field)
        if d is None:
            if field not in (".pos", "block_table"):
                raise NotImplementedError(
                    f"cache field {path} is not yet ported under --tp / "
                    "dist (KV caches only)")
            return ()
        d = leaf.dim() + d
        if leaf.shape[d] % tp:
            raise NotImplementedError(
                f"{leaf.shape[d]} KV heads on {tp} ranks are not yet "
                "ported under --tp / dist")
        return _finish([None] * d + [dist.tp_axis])
    return spec


def gather_cache_field(x, field: str, stacked: bool,
                       dist: Optional[DistContext]):
    """The whole of a KV cache field (``".k_s"``, ``".pos"``, ...; a
    stacked leaf with ``stacked``) that :func:`place_cache` cut: its
    sequence dim (the default layout) or its KV-head dim gathered over
    ``model`` in rank order; a field the layout keeps whole, or no
    ``dist``, returns ``x``."""
    if dist is None:
        return x
    from repro_torch.parallel import collectives as coll
    if dist.kv_seq_shard:
        dim = 2 if stacked else 1
    elif field in _KV_HEAD_DIM:
        dim = x.dim() + _KV_HEAD_DIM[field]
    else:
        return x
    return coll.all_gather(x, dist, dim)


def make_kv_head_specs(cache, dist: DistContext):
    """The KV-head placement the port's serving executes with
    ``kv_seq_shard=False``: every KV cache field on its KV-head dim over
    ``model`` (query heads [r*H/N, (r+1)*H/N) go with KV heads
    [r*KV/N, (r+1)*KV/N)), positions and the block table replicated. The
    payload specs equal :func:`cache_spec_for`'s with
    ``kv_seq_shard=False`` (batch on ``data``, size 1 here, aside); the
    reference puts scales and positions on the sequence dim instead, which
    only its GSPMD layout can execute."""
    return _map_with_path(_kv_head_spec_of(dist), cache)


def make_kv_head_shardings(cache, dist: DistContext):
    """``cache`` placed on ``dist.mesh`` by :func:`make_kv_head_specs`."""
    return place(cache, _kv_head_spec_of(dist), dist.mesh)


def seed_weight_memo(cfg, whole, placed, ctx, dist: DistContext) -> dict:
    """The weight memo of a rank: for every float weight the forward
    reads (``transformer.weight_reads``), the key of its placed view and
    this rank's slice of the fake-quant of the WHOLE weight, with the
    whole weight's grid (the reference fits it on the logical array).
    ``ctx`` is a ctx of the serving session (its policy and mode decide
    which weights are fake-quantized); ``whole`` and ``placed`` are the
    params before and after :func:`make_param_shardings`. Serve with the
    memo as ``weight_cache`` and ``memo_only=True``."""
    from repro_torch.core.calibration import QuantCtx
    from repro_torch.models.transformer import weight_reads
    probe = dataclasses.replace(ctx, weight_cache=None, memo_only=False,
                                telemetry=None)
    r = dist.mesh.coords[dist.tp_axis]
    memo = {}
    for (site, w), (site_l, w_l) in zip(weight_reads(cfg, whole),
                                        weight_reads(cfg, placed)):
        if site != site_l:
            raise ValueError(f"placed params read {site_l} where the whole "
                             f"params read {site}")
        fq = probe.weight(site, w)
        for d in range(w.dim()):
            if w_l.shape[d] != w.shape[d]:
                fq = fq.narrow(d, r * w_l.shape[d], w_l.shape[d])
        memo[QuantCtx.memo_key(site, w_l)] = (
            w_l, fq.clone(memory_format=torch.contiguous_format))
    return memo


def weight_cut_dims(cfg, dist: DistContext) -> dict:
    """{site: dim} for every float weight the forward reads
    (``transformer.weight_reads``) that the ``model`` axis cuts: the dim of
    the weight as read at the site (a stacked leaf's layer slice, the tied
    head's ``embed.T``) that :func:`param_spec_for` puts on ``model``.
    Training reads every weight gathered over the FSDP axis, so a weight
    at a site listed here is this rank's ``model`` slice of it."""
    from repro_torch.models.transformer import weight_reads
    logical = logical_params(cfg)
    spec_of, tp = _param_spec_of(dist), dist.tp_axis

    def model_cut(path, w):
        shape = list(w.shape)
        for d, entry in enumerate(spec_of(path, w)):
            if tp in _axes_of(entry):
                shape[d] //= _axis_size(dist.mesh, entry)
        return w.new_empty(shape)
    cut = _map_with_path(model_cut, logical)
    dims = {}
    for (site, w), (_, w_l) in zip(weight_reads(cfg, logical),
                                   weight_reads(cfg, cut)):
        for d in range(w.dim()):
            if w.shape[d] != w_l.shape[d]:
                dims[site] = d
    return dims


def shard_ctx_factory(cfg, whole, placed, ctx_factory, dist: DistContext):
    """``ctx_factory`` for a rank serving ``placed`` (its slice of
    ``whole``): every ctx it makes reads the rank's weight memo
    (:func:`seed_weight_memo`, filled once here) with ``memo_only``."""
    if ctx_factory is None:
        return None
    probe = ctx_factory()
    if probe is None:
        return ctx_factory
    memo = seed_weight_memo(cfg, whole, placed, probe, dist)

    def factory():
        ctx = ctx_factory()
        ctx.weight_cache = memo
        ctx.memo_only = True
        return ctx
    return factory


def constrain(x, dist: Optional[DistContext], spec):
    """The reference's layout hint; a rank holds its slice already, so this
    is the identity."""
    return x


def serving_dist(mesh) -> DistContext:
    """The DistContext the port's serving builds: the reference's
    :func:`make_dist`, its caches on the sequence dim (``kv_seq_shard``).
    ``dataclasses.replace(serving_dist(mesh), kv_seq_shard=False)``
    serves the KV-head layout."""
    return make_dist(mesh)
