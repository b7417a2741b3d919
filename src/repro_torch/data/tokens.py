"""Deterministic synthetic token pipeline (LM training substrate).

A copy of the reference's `data/tokens.py` (numpy only): the same seeds
and draws, so its batches are bit-identical to the reference's.
Host-sharded: each process materializes only its shard of the global batch
(`process_index` / `process_count`). A Zipf-ish unigram mixture with
induced bigram structure gives the loss something learnable.
"""
from __future__ import annotations

import numpy as np


class TokenStream:
    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, process_index: int = 0,
                 process_count: int = 1):
        assert global_batch % process_count == 0
        self.vocab = vocab
        self.seq_len = seq_len
        self.local_batch = global_batch // process_count
        self.seed = seed
        self.process_index = process_index
        # bigram table: each token prefers a small successor set
        rng = np.random.default_rng(seed)
        self.succ = rng.integers(0, vocab, size=(vocab, 4))

    def batch(self, step: int) -> np.ndarray:
        """(local_batch, seq_len + 1) int32, deterministic in (step, shard)."""
        rng = np.random.default_rng(
            (self.seed, step, self.process_index))
        out = np.empty((self.local_batch, self.seq_len + 1), dtype=np.int32)
        # Zipf-ish start tokens
        start = rng.zipf(1.3, size=self.local_batch) % self.vocab
        out[:, 0] = start
        for t in range(1, self.seq_len + 1):
            choice = rng.integers(0, 4, size=self.local_batch)
            noise = rng.random(self.local_batch) < 0.1
            nxt = self.succ[out[:, t - 1], choice]
            nxt = np.where(noise,
                           rng.integers(0, self.vocab, self.local_batch),
                           nxt)
            out[:, t] = nxt
        return out
