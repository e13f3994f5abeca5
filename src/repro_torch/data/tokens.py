"""Synthetic LM token pipeline for the model zoo (numpy only): the port's
own copy of the JAX package's ``repro.data.tokens``, so that nothing of
the port needs the JAX package.  The same arguments and seed give the same
batches, bit for bit.

Produces an infinite stream of (tokens, targets) batches from a mixture
of Zipf-distributed unigrams and short Markov motifs, so losses fall
smoothly during the example training runs (unlike uniform noise).
"""

from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np


class Batch(NamedTuple):
    tokens: np.ndarray    # (B, S) int32
    targets: np.ndarray   # (B, S) int32  (tokens shifted left)


class TokenPipeline:
    def __init__(self, vocab_size: int, seq_len: int, batch_size: int,
                 *, seed: int = 0, motif_len: int = 8,
                 num_motifs: int = 512):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        v = min(vocab_size, 50_000)
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self.probs = (1.0 / ranks) / np.sum(1.0 / ranks)
        self.vocab_used = v
        self.motifs = self.rng.integers(
            0, v, size=(num_motifs, motif_len)).astype(np.int32)

    def __iter__(self) -> Iterator[Batch]:
        while True:
            yield self.next_batch()

    def next_batch(self) -> Batch:
        b, s = self.batch_size, self.seq_len
        toks = self.rng.choice(self.vocab_used, size=(b, s + 1),
                               p=self.probs).astype(np.int32)
        # splice motifs (so there is learnable local structure)
        n_splice = max(1, s // (4 * self.motifs.shape[1]))
        for i in range(b):
            for _ in range(n_splice):
                m = self.motifs[self.rng.integers(len(self.motifs))]
                pos = self.rng.integers(0, s + 1 - len(m))
                toks[i, pos:pos + len(m)] = m
        return Batch(tokens=toks[:, :-1], targets=toks[:, 1:])
