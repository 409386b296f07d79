"""Checkpointable input pipeline (port of ``repro.data.pipeline``).

The iterator state is just (seed, step): generation is deterministic per
(seed, index), so a restart after a failure replays the exact token
stream. Batches stay numpy arrays on the host; the training loop's
``put_batch`` moves them to the device. The reference's ``shard_batch``
waits for multi-device training (ROADMAP Queue 1 item 6).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

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
