"""Checkpointable input pipeline (port of ``repro.data.pipeline``).

The iterator state is just (seed, step): generation is deterministic per
(seed, index), so a restart after a failure replays the exact token
stream. Batches stay numpy arrays on the host; the training loop's
``put_batch`` moves them to the device, on a rank mesh through
:func:`shard_batch` (the rank's data-parallel rows). :class:`DrawnBatches`
hands the ranks of a mesh batches drawn once from one source.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Optional

import numpy as np


@dataclasses.dataclass
class IteratorState:
    seed: int
    step: int

    def to_dict(self):
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_dict(cls, d):
        return cls(seed=int(d["seed"]), step=int(d["step"]))


class DataPipeline:
    """Wraps a generator with ``.batch(batch_size, index)`` into a stateful,
    checkpointable iterator."""

    def __init__(self, source, batch_size: int,
                 state: Optional[IteratorState] = None, seed: int = 0):
        self.source = source
        self.batch_size = batch_size
        self.state = state or IteratorState(seed=seed, step=0)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = self.source.batch(self.batch_size, self.state.step)
        self.state.step += 1
        return batch

    def checkpoint_state(self) -> dict:
        return self.state.to_dict()

    def restore_state(self, d: dict):
        self.state = IteratorState.from_dict(d)


class DrawnBatches:
    """A source of batches drawn beforehand from ``source`` at
    ``indices`` (its ``cfg`` and ``seed`` with them): what the ranks of a
    mesh share, so no rank builds the source itself (at full width its
    Markov table takes a minute and 8.4 GB). ``batch`` of an index not
    drawn raises."""

    def __init__(self, source, batch_size: int, indices: Iterable[int]):
        self.cfg, self.seed = source.cfg, source.seed
        self.batch_size = batch_size
        self.batches = {int(i): source.batch(batch_size, int(i))
                        for i in indices}

    def batch(self, batch_size: int, index: int) -> Dict[str, np.ndarray]:
        if batch_size != self.batch_size or index not in self.batches:
            raise KeyError(f"batch {index} of {batch_size} rows was not "
                           f"drawn (drawn: {sorted(self.batches)} of "
                           f"{self.batch_size})")
        return self.batches[index]


def shard_batch(batch: Dict[str, np.ndarray], dist,
                microbatches: int = 1) -> Dict[str, np.ndarray]:
    """This rank's rows of the host batch (the reference's
    ``shard_batch``: each leaf's leading dim over the data-parallel axes,
    ``parallel.sharding.make_batch_shardings``). With ``microbatches`` M,
    the rows are microbatch i's dp block for each i in turn (the rows the
    reference's scan hands the rank's shard), so that the train step cuts
    them into M microbatches by a reshape alone; M = 1 is the contiguous
    block at the rank's dp index. A leaf whose rows M microbatches over
    the axes do not divide is refused, since every rank would then train
    on every row."""
    import torch
    from repro_torch.parallel.sharding import make_batch_shardings
    specs = make_batch_shardings(
        {k: torch.empty(np.shape(v)[:1], device="meta")
         for k, v in batch.items()}, dist)
    dp = dist.mesh.index(dist.dp_axes)
    n_dp = math.prod(dist.mesh.shape[a] for a in dist.dp_axes)
    out = {}
    for k, v in batch.items():
        rows = np.shape(v)[0]
        if not specs[k] or rows % (n_dp * microbatches):
            raise NotImplementedError(
                f"batch leaf {k!r} of {rows} rows in {microbatches} "
                f"microbatches over {dist.dp_axes} is not yet ported under "
                "--tp / dist (its rows must divide over the data-parallel "
                "ranks)")
        n = rows // (n_dp * microbatches)
        per = np.reshape(v, (microbatches, n_dp, n) + np.shape(v)[1:])
        out[k] = np.reshape(per[:, dp], (microbatches * n,) +
                            np.shape(v)[1:])
    return out
