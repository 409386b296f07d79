"""Tensor-parallel placement (``sharding``) and the collectives over a rank
mesh (``collectives``). The sharding names are loaded on first use:
``models.transformer`` imports the collectives, and ``sharding`` imports
``models.transformer``'s ``DistContext``."""
from __future__ import annotations

import importlib

_SHARDING = ("NamedSharding", "batch_spec", "cache_spec_for", "constrain",
             "cut_leaf", "gather_leaf", "gather_logical",
             "logical_params",
             "make_abstract_mesh", "make_batch_shardings",
             "make_cache_shardings", "make_cache_specs", "make_dist",
             "make_kv_head_shardings",
             "make_kv_head_specs", "make_opt_shardings",
             "make_param_shardings", "make_param_specs",
             "make_seq_cache_shardings", "make_seq_cache_specs",
             "param_shardings", "param_spec_for", "place", "place_cache",
             "replication", "serving_dist")

__all__ = list(_SHARDING)


def __getattr__(name):
    if name in _SHARDING:
        module = importlib.import_module("repro_torch.parallel.sharding")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
