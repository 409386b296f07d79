"""Checkpointing with async save, step housekeeping and an atomic publish
(port of ``repro.checkpoint.checkpointer``), in the reference's on-disk
format, so a checkpoint written by either package restores in the other:

    <dir>/step_<step:08d>/arrays.npz   one array per leaf, keyed by the
                                       leaf's path (``['embed']``, ``[0]``,
                                       ``.mu``, ... joined with ``||``)
    <dir>/step_<step:08d>/meta.json    step, time, ``dtypes`` (bf16 leaves
                                       are stored as their uint16 bits) and
                                       the caller's extras (data state)

Trees are nested dicts (keys in sorted order), lists, tuples and
NamedTuples of tensors, the paths the reference's
``jax.tree_util.tree_flatten_with_path`` gives them. On a rank mesh
(``shardings``: a tree of ``parallel.sharding.NamedSharding`` beside the
tree) a checkpoint holds the logical arrays, so the saved layout does not
depend on the mesh: ``save`` gathers each leaf over the mesh and rank 0
writes while the others wait, and ``restore`` cuts each rank's slice of
the logical arrays (a checkpoint of one mesh resumes on another, or on one
device). Leaves go to the template's devices.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

_SEP = "||"


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, object]]:
    """(path key, leaf) pairs in the reference's order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], prefix + (f"[{k!r}]",))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for f in tree._fields
                for kv in _flatten(getattr(tree, f), prefix + (f".{f}",))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, prefix + (f"[{i}]",))]
    if tree is None:
        return []
    return [(_SEP.join(prefix), tree)]


def _unflatten(template, leaves: Dict[str, object],
               prefix: Tuple[str, ...] = ()):
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, prefix + (f"[{k!r}]",))
                for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(
            _unflatten(getattr(template, f), leaves, prefix + (f".{f}",))
            for f in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(
            _unflatten(v, leaves, prefix + (f"[{i}]",))
            for i, v in enumerate(template))
    if template is None:
        return None
    return leaves[_SEP.join(prefix)]


def _to_host(leaf) -> Tuple[np.ndarray, Optional[str]]:
    """A host copy of one leaf and, for bf16, the dtype its uint16 bits
    stand for."""
    if isinstance(leaf, torch.Tensor):
        # a copy even on the CPU: the caller may update the tensor in
        # place while the write is in flight
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), None
    return np.asarray(leaf), None


def _from_host(arr: np.ndarray, dtype: Optional[str], dev):
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    elif dtype is not None:
        raise ValueError(f"cannot restore a {dtype} leaf")
    else:
        t = torch.from_numpy(arr)
    return t.to(dev)


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree, *, extra: Optional[dict] = None,
             block: bool = False, shardings=None):
        """Snapshot the tree at ``step``. With async_save the host copy is
        taken synchronously and the disk write happens in a background
        thread: training continues (and may update the tensors in place).
        ``shardings``: ``tree`` holds this rank's slices; every rank of
        the mesh calls ``save``, each leaf is gathered whole, rank 0
        writes it (synchronously) and every rank returns once the
        checkpoint is published."""
        self.wait()                       # at most one outstanding write
        host_flat, dtypes = {}, {}
        mesh = None
        if shardings is not None:
            from repro_torch.parallel.sharding import gather_leaf
            sh = dict(_flatten(shardings))
            mesh = next(iter(sh.values())).mesh
        for k, v in _flatten(tree):
            if mesh is not None:
                v = gather_leaf(v, sh[k])
                if mesh.rank != 0:
                    continue
            host_flat[k], dt = _to_host(v)
            if dt is not None:
                dtypes[k] = dt
        meta = {"step": int(step), "time": time.time(), "dtypes": dtypes,
                **(extra or {})}

        def _write():
            tmp = os.path.join(self.directory, f".tmp-{step}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **host_flat)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            final = os.path.join(self.directory, f"step_{step:08d}")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)         # atomic publish
            self._gc()

        if mesh is not None:
            from repro_torch.parallel import collectives as coll
            if mesh.rank == 0:
                _write()
            coll.barrier(mesh)
        elif self.async_save and not block:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def all_steps(self):
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.directory, name,
                                                 "meta.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None, shardings=None):
        """Restore into the structure of ``template``, each leaf on the
        device of the template's leaf. ``shardings`` (a ``NamedSharding``
        tree like ``template``, whose leaves are this rank's slices): each
        leaf is this rank's slice of the logical array read, whatever mesh
        saved it. Returns (tree, meta)."""
        sh = dict(_flatten(shardings)) if shardings is not None else None
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        dtypes = meta.get("dtypes", {})
        leaves = {}
        with np.load(os.path.join(d, "arrays.npz")) as arrays:
            for key, like in _flatten(template):
                t = _from_host(arrays[key], dtypes.get(key), "cpu")
                if sh is not None:
                    from repro_torch.parallel.sharding import cut_leaf
                    t = cut_leaf(t, sh[key])
                if isinstance(like, torch.Tensor) and t.shape != like.shape:
                    raise ValueError(
                        f"checkpoint leaf {key} restores as "
                        f"{tuple(t.shape)}, the template's is "
                        f"{tuple(like.shape)}")
                dev = like.device if isinstance(like, torch.Tensor) \
                    else "cpu"
                leaves[key] = t.to(dev)
        return _unflatten(template, leaves), meta
