"""Carry weights, calibrations and KV caches across from the reference
package.

The reference's ``jax.random`` initialization cannot be reproduced with
``torch.Generator``, so parity tests build the reference's params, turn them
into numpy on the JAX side (``np.asarray`` per leaf) and hand the nested
dicts / lists of numpy arrays to :func:`params_from_jax`. This module itself
imports no JAX: it only sees numpy arrays (and objects with ``scale`` /
``zero_point`` / ``group_index`` attributes for the act state).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quantizer import QuantParams
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.encdec import DecoderCache
from repro_torch.models.rglru import RGLRUState
from repro_torch.models.rwkv6 import RWKVState

# the reference's cache NamedTuples, by class name, and the port's types
_CACHE_TYPES = {cls.__name__: cls for cls in (
    attn.KVCache, attn.QuantKVCache, attn.Quant4KVCache, attn.PagedKVCache,
    attn.PagedQuantKVCache, attn.PagedQuant4KVCache, RGLRUState, RWKVState,
    DecoderCache)}


def _tensor(a, device, dtype=None):
    a = np.asarray(a)
    if a.dtype.kind == "V" or str(a.dtype) == "bfloat16":
        # numpy has no native bf16: go through f32, then round to bf16
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        t = t.to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))   # a writable, contiguous copy
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(tree, device=None, dist=None):
    """Nested dicts / lists of numpy arrays -> the same structure of torch
    tensors on ``device`` (None: the GPU). Handles the stacked (``"scan"``)
    and unrolled (``"layers"``) layouts and packed ``{"q", "s", "colsum"}``
    and 4-bit ``{"q4", "s", "colsum"}`` payloads alike, since it maps leaf
    by leaf. With ``dist`` (a rank's ``DistContext``) the params are placed
    as the port's own are (``parallel.sharding.make_param_shardings``):
    the rank keeps its slice."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        return _tensor(node, dev)
    params = conv(tree)
    if dist is not None:
        from repro_torch.parallel.sharding import make_param_shardings
        params = make_param_shardings(params, dist)
    return params


def act_state_from_jax(act_state, device=None):
    """A reference act state (site -> QuantParams-like with numpy-convertible
    ``scale``, ``zero_point`` and optional ``group_index``) -> the port's
    QuantParams on ``device``."""
    dev = resolve_device(device)
    out = {}
    for site, qp in act_state.items():
        gi = None if qp.group_index is None else _tensor(
            qp.group_index, dev, torch.int64)
        out[site] = QuantParams(scale=_tensor(qp.scale, dev, torch.float32),
                                zero_point=_tensor(qp.zero_point, dev,
                                                   torch.float32),
                                group_index=gi)
    return out


def caches_from_jax(tree, device=None):
    """A reference whole-model cache (dicts / lists of its cache
    NamedTuples with numpy-convertible leaves, stacked ``"scan"`` or
    unrolled ``"layers"`` layout, with a paged ``"block_table"``) -> the
    same structure of the port's cache types on ``device`` (None: the GPU);
    the int4 caches keep their type, the bit-width marker, and the
    recurrent states (``RGLRUState``, ``RWKVState``) theirs. An
    encoder-decoder ``DecoderCache`` (whose ``self_kv`` is itself a stacked
    ``KVCache``) converts field by field. A cache type the port does not
    have raises."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            cls = _CACHE_TYPES.get(type(node).__name__)
            if cls is None:
                raise NotImplementedError(
                    f"{type(node).__name__} caches are not yet ported")
            return cls(*(conv(x) for x in node))
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        return _tensor(node, dev)
    return conv(tree)
