"""Deterministic synthetic data (a numpy copy of ``repro.data.synthetic``;
its batches are byte-identical to the reference's for every task).

Two generators:

  * ``SyntheticLM`` — next-token-predictable token streams for LM training
    (a planted k-gram Markov structure so the loss has signal).
  * ``SyntheticGLUE`` — classification/regression sentence-pair tasks with
    the shape of GLUE: each task hides a token-level rule (separator-token
    sensitive, mirroring the paper's [SEP]-attention analysis) that a small
    BERT can learn to >90% accuracy in a few hundred steps.

All sampling is derived from a seed + element index, so an iterator can be
checkpointed as (seed, position) and resumed exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import zlib

import numpy as np

CLS, SEP, PAD = 1, 2, 0      # special token ids (vocab reserves 0-9)


@dataclasses.dataclass(frozen=True)
class LMTaskConfig:
    vocab_size: int
    seq_len: int
    order: int = 2            # markov order of the planted structure
    temperature: float = 1.0


def _markov_table(vocab: int, order: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    # sparse-ish preferred-successor table: each context strongly prefers
    # a handful of tokens -> learnable signal
    ctx = 4096
    table = rng.dirichlet(np.full(vocab, 0.05), size=ctx)
    return table.astype(np.float32)


class SyntheticLM:
    def __init__(self, cfg: LMTaskConfig, seed: int = 0):
        self.cfg = cfg
        self.seed = seed
        self.table = _markov_table(cfg.vocab_size, cfg.order, seed)

    def batch(self, batch_size: int, index: int) -> Dict[str, np.ndarray]:
        """Deterministic: (seed, index) -> batch."""
        rng = np.random.RandomState((self.seed * 1_000_003 + index) % 2**31)
        v, t = self.cfg.vocab_size, self.cfg.seq_len
        toks = np.zeros((batch_size, t), np.int32)
        toks[:, 0] = rng.randint(10, v, size=batch_size)
        state = toks[:, 0].astype(np.int64)
        for i in range(1, t):
            ctx = (state * 2654435761 % self.table.shape[0])
            probs = self.table[ctx]
            cum = probs.cumsum(axis=1)
            u = rng.rand(batch_size, 1)
            nxt = (u < cum).argmax(axis=1)
            toks[:, i] = np.maximum(nxt, 10)
            state = (state * 31 + toks[:, i]) % (2**31 - 1)
        return {"tokens": toks, "labels": toks.copy()}


@dataclasses.dataclass(frozen=True)
class GLUETaskConfig:
    """A synthetic task shaped like one GLUE entry.

    content_vocab bounds the distinct content tokens (drawn from
    [10, 10+content_vocab)): small content vocabularies make the hidden
    rules learnable by a reduced BERT within a CPU training budget while the
    embedding table stays full-sized."""
    name: str
    vocab_size: int = 1024
    seq_len: int = 64
    num_labels: int = 2
    regression: bool = False
    rule: str = "match"        # match | parity | overlap | order | lookup
    content_vocab: int = 32


GLUE_SUITE = [
    GLUETaskConfig("syn-cola", rule="parity", content_vocab=8),
    GLUETaskConfig("syn-sst2", rule="lookup", content_vocab=32),
    GLUETaskConfig("syn-mrpc", rule="lookup", content_vocab=16),
    GLUETaskConfig("syn-stsb", rule="overlap", regression=True, num_labels=1,
                   content_vocab=32),
    GLUETaskConfig("syn-qqp", rule="overlap", content_vocab=32),
    GLUETaskConfig("syn-mnli", rule="order", num_labels=3, content_vocab=16),
    GLUETaskConfig("syn-qnli", rule="order", content_vocab=16),
    GLUETaskConfig("syn-rte", rule="order", content_vocab=8),
]


class SyntheticGLUE:
    """Sentence-pair tasks: [CLS] a... [SEP] b... [SEP] [PAD]...

    Rules (label depends on the pair, computable by an encoder):
      match:   label = 1 if multiset of b's first 3 content tokens ⊆ a
      parity:  label = parity of count of tokens < vocab/2 in a
      overlap: label/score = |a ∩ b| bucketed (regression: fraction)
      order:   label = 1 if first content token of a < first of b
    """

    def __init__(self, cfg: GLUETaskConfig, seed: int = 0):
        self.cfg = cfg
        self.seed = seed

    def batch(self, batch_size: int, index: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.RandomState(
            (zlib.crc32(c.name.encode()) % 65536 * 7 +
             self.seed * 1_000_003 + index) % 2**31)
        half = (c.seq_len - 3) // 2
        hi = min(10 + c.content_vocab, c.vocab_size)
        a = rng.randint(10, hi, size=(batch_size, half))
        b = rng.randint(10, hi, size=(batch_size, half))

        if c.rule == "lookup":
            # label = fixed random class of a's first content token — a pure
            # embedding-lookup task (the easiest probe of the pipeline)
            table = np.random.RandomState(
                zlib.crc32(c.name.encode()) % 65536) \
                .randint(0, c.num_labels, size=c.vocab_size)
            labels = table[a[:, 0]].astype(np.int32)
        elif c.rule == "match":
            # clean paired equality: half the batch copies b[0] <- a[0]
            # (label 1); the other half explicitly resamples b[0] != a[0]
            # so labels are noise-free
            m = batch_size // 2
            b[:m, 0] = a[:m, 0]
            neq = b[m:, 0] == a[m:, 0]
            while np.any(neq):
                b[m:, 0] = np.where(neq, rng.randint(10, hi, size=b[m:, 0].shape),
                                    b[m:, 0])
                neq = b[m:, 0] == a[m:, 0]
            labels = np.zeros(batch_size, np.int32)
            labels[:m] = c.num_labels - 1
        elif c.rule == "parity":
            # parity of {a[0] < mid} XOR {b[0] < mid}: a 2-feature parity —
            # genuinely harder than lookup/order (our CoLA analogue) but
            # within reach of a small encoder
            mid = 10 + c.content_vocab // 2
            labels = (((a[:, 0] < mid).astype(np.int32) +
                       (b[:, 0] < mid).astype(np.int32)) % 2).astype(np.int32)
        elif c.rule == "overlap":
            # per-position equality on the first 4 positions, constructed:
            # k ~ U{0..4} positions are copied, the rest explicitly differ;
            # regression score = k/4, classification label = k >= 2
            k = rng.randint(0, 5, size=batch_size)
            for i in range(batch_size):
                b[i, :k[i]] = a[i, :k[i]]
                for j in range(k[i], 4):
                    while b[i, j] == a[i, j]:
                        b[i, j] = rng.randint(10, hi)
            frac = k / 4.0
            if c.regression:
                labels = frac.astype(np.float32)
            else:
                labels = (k >= 2).astype(np.int32)
        elif c.rule == "order":
            if c.num_labels == 3:       # mnli-style: less / equal / greater
                labels = (np.sign(a[:, 0].astype(np.int64) -
                                  b[:, 0].astype(np.int64)) + 1).astype(np.int32)
            else:
                labels = (a[:, 0] < b[:, 0]).astype(np.int32)
        else:
            raise ValueError(c.rule)

        toks = np.full((batch_size, c.seq_len), PAD, np.int32)
        toks[:, 0] = CLS
        toks[:, 1:1 + half] = a
        toks[:, 1 + half] = SEP
        toks[:, 2 + half:2 + 2 * half] = b
        toks[:, 2 + 2 * half] = SEP
        type_ids = np.zeros((batch_size, c.seq_len), np.int32)
        type_ids[:, 2 + half:] = 1
        pad_mask = toks != PAD
        return {"tokens": toks, "type_ids": type_ids, "pad_mask": pad_mask,
                "labels": labels}

    def metric(self, preds: np.ndarray, labels: np.ndarray) -> float:
        """Accuracy (or pearson-like correlation for regression),
        in [0, 100] like GLUE scores."""
        if self.cfg.regression:
            p = preds - preds.mean()
            l = labels - labels.mean()
            denom = np.sqrt((p * p).sum() * (l * l).sum()) + 1e-9
            return float(100.0 * (p * l).sum() / denom)
        return float(100.0 * (preds == labels).mean())
