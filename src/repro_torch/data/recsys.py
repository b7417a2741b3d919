"""RecSys data substrate: synthetic interaction sequences + embedding-bag.

The port of the reference's `data/recsys.py`. `InteractionStream` is a
copy (numpy only, the same seeds and draws, so its batches are the
reference's bit for bit): SASRec training triples (seq, pos, neg) from a
latent-factor user/item model, so that the BPR loss is learnable.

`embedding_bag` keeps the reference's semantics, which are not
`torch.nn.functional.embedding_bag`'s: an empty bag's `max` is -inf (the
identity of max, as the reference's segment max fills), where
F.embedding_bag gives 0; and `weights` scale the members in every mode,
where F.embedding_bag takes per-sample weights only for `sum`.
"""
from __future__ import annotations

import numpy as np
import torch


class InteractionStream:
    def __init__(self, n_items: int, seq_len: int, batch: int,
                 n_latent: int = 8, seed: int = 0,
                 process_index: int = 0, process_count: int = 1):
        assert batch % process_count == 0
        self.n_items = n_items
        self.seq_len = seq_len
        self.local_batch = batch // process_count
        self.seed = seed
        self.process_index = process_index
        rng = np.random.default_rng(seed)
        # latent item factors drive coherent sequences
        self.item_f = rng.normal(size=(n_items, n_latent)).astype(np.float32)

    def batch(self, step: int):
        """(seq, pos, neg), each (local_batch, seq_len) int32 numpy."""
        rng = np.random.default_rng((self.seed, step, self.process_index))
        b, s = self.local_batch, self.seq_len
        user = rng.normal(size=(b, self.item_f.shape[1])).astype(np.float32)
        # per-user item affinity -> top pool -> random walk over the pool
        pool = 64
        scores = user @ self.item_f.T
        top = np.argpartition(-scores, pool, axis=1)[:, :pool]
        idx = rng.integers(0, pool, size=(b, s + 1))
        items = np.take_along_axis(top, idx, axis=1) + 1  # 0 = PAD
        seq = items[:, :-1].astype(np.int32)
        pos = items[:, 1:].astype(np.int32)
        neg = rng.integers(1, self.n_items, size=(b, s)).astype(np.int32)
        return seq, pos, neg


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  offsets: torch.Tensor, mode: str = "sum",
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """torch.nn.EmbeddingBag's layout with the reference's semantics.

    table (V, D); indices (nnz,) flat bag members; offsets (B,) bag starts
    (the first 0). Returns (B, D) reduced embeddings. mode: sum | mean |
    max; an empty bag gives 0, 0 and -inf."""
    nnz = indices.shape[0]
    b = offsets.shape[0]
    rows = table[indices.long()]                              # gather
    if weights is not None:
        rows = rows * weights[:, None]
    # bag id per member: the last bag start at or before it
    bag = torch.searchsorted(
        offsets, torch.arange(nnz, dtype=offsets.dtype,
                              device=offsets.device), right=True) - 1
    if mode in ("sum", "mean"):
        s = rows.new_zeros((b, rows.shape[1])).index_add_(0, bag, rows)
        if mode == "sum":
            return s
        c = rows.new_zeros((b, 1)).index_add_(
            0, bag, rows.new_ones((nnz, 1)))
        return s / torch.clamp(c, min=1.0)
    if mode == "max":
        return rows.new_full((b, rows.shape[1]), -torch.inf).scatter_reduce_(
            0, bag[:, None].expand_as(rows), rows, "amax",
            include_self=False)
    raise ValueError(mode)
