"""STREAK top-k retrieval as a serving primitive.

The port of the reference's `serve/retrieval.py`: the paper's ORDER BY ...
LIMIT machinery (block-wise scoring, per-block upper bounds, threshold
early termination) applied to candidate scoring.

- `blocked_topk`: every item block scored, a running top-k carried: the
  fixed full scan (the offline bulk path).
- `streak_topk`: blocks pre-sorted by their score UPPER BOUND (the block's
  largest ||e_i||, a Cauchy-Schwarz bound: the analogue of the paper's
  numeric-index block_max), and the scan stops at the first block whose
  bound cannot beat theta, the k-th best score so far, in any row. This is
  the paper's N-Plan early termination. The loop's test is one read from
  the device a block.

Both are exact (the true top-k) and order their results as the
reference's `jax.lax.top_k` merge does: by score, descending, the lower
position of the merged row first among equal scores, so the running top-k
wins a tie against a new block and an earlier item against a later one.
`torch.topk` promises no order among equal values, so the merge selects by
value and then by position itself (`_stable_topk`). The products are f32
`torch.matmul`s (TF32 stays off, as torch's default has it, so that the
scores are f32's).

The sharded variants (`streak_topk_sharded`, `blocked_topk_sharded`) lay
the catalog over one axis of a device mesh (`launch/mesh.py`): shard i owns
the reference's contiguous `P(axis, None)` slice, runs the unsharded scan
on its own device, and one k-wide gather to the mesh's first position
merges the shards' top-k, the lower shard first among equal scores (the
reference's `all_gather` then `lax.top_k`). Given DTensors (the dry run's
SPMD step, `launch/cells.py`), they run as one rank of the mesh: the scan
over this rank's block of the catalog, then an all-gather of the k-wide
results over `axis` and the same merge.
"""
from __future__ import annotations

import torch

from ..launch.mesh import shard_blocks


def _stable_topk(s: torch.Tensor, k: int) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """The k best of each row of s (B, W), k <= W, as (scores, positions):
    by score descending, the lower position first among equal scores (the
    reference's top_k). The set is every score above the row's k-th best
    and the lowest positions of those equal to it; `torch.topk` finds both
    (values first, then positions by a key that ranks them), and a stable
    sort of the k orders them."""
    w = s.shape[-1]
    if k < w:
        kth = torch.topk(s, k, dim=-1, sorted=False).values.amin(
            -1, keepdim=True)
        pos = torch.arange(w, dtype=torch.int32, device=s.device)
        key = torch.where(s > kth, w, torch.where(s == kth, w - 1 - pos, -1))
        sel = torch.topk(key, k, dim=-1, sorted=False).indices
        sel = torch.sort(sel, dim=-1).values
        vals = torch.gather(s, -1, sel)
    else:
        sel = torch.arange(w, device=s.device).expand_as(s)
        vals = s
    vals, order = torch.sort(vals, dim=-1, descending=True, stable=True)
    return vals, torch.gather(sel, -1, order)


def _merge_topk(scores, ids, new_scores, new_ids, k: int):
    s = torch.cat([scores, new_scores], dim=-1)
    i = torch.cat([ids, new_ids], dim=-1)
    top_s, pos = _stable_topk(s, k)
    return top_s, torch.gather(i, -1, pos)


def _init(state: torch.Tensor, k: int):
    b = state.shape[0]
    return (torch.full((b, k), -torch.inf, dtype=state.dtype,
                       device=state.device),
            torch.zeros((b, k), dtype=torch.int32, device=state.device))


def blocked_topk(state: torch.Tensor, items: torch.Tensor, k: int = 100,
                 block: int = 65536):
    """state (B, D) x items (N, D) -> (scores (B, k), ids (B, k) int32).

    Full blocked scan: every item block is scored; memory stays at
    (B, block) instead of (B, N). Where N < k the rows are filled with
    (-inf, id 0), as in the reference."""
    n = items.shape[0]
    scores, ids = _init(state, k)
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        s = state @ items[lo:hi].T                           # (B, <= block)
        cand = torch.arange(lo, hi, dtype=torch.int32, device=state.device)
        scores, ids = _merge_topk(scores, ids, s, cand.expand_as(s), k)
    return scores, ids


def block_bounds(items: torch.Tensor, block: int) -> torch.Tensor:
    """Per-block score upper-bound material: max ||item|| per block."""
    n = items.shape[0]
    nb = -(-n // block)
    norms = torch.sqrt(torch.sum(items * items, dim=-1))
    norms = torch.cat([norms, norms.new_zeros(nb * block - n)])
    return norms.reshape(nb, block).amax(dim=1)              # (nb,)


def sort_items_by_norm(items: torch.Tensor, block: int):
    """Reorder the catalog by descending norm so block bounds decrease: the
    analogue of STREAK's value-sorted numeric index (a build-time step).
    Returns (items_sorted, order); equal norms keep catalog order (a
    stable sort, as the reference's argsort)."""
    norms = torch.sqrt(torch.sum(items * items, dim=-1))
    order = torch.argsort(-norms, stable=True)
    return items[order], order


def streak_topk(state: torch.Tensor, items_sorted: torch.Tensor,
                item_order: torch.Tensor, bounds: torch.Tensor,
                k: int = 100, block: int = 65536):
    """Early-terminating top-k over a norm-sorted catalog.

    state (B, D); items_sorted (N, D) by descending norm; item_order (N,)
    the catalog id of each sorted row; bounds (nb,) from `block_bounds`.
    Stops at the first block where ||state|| * bound <= theta (the k-th
    best score so far) in every row: no later block can contribute
    (Cauchy-Schwarz), the paper's threshold test against the numeric
    block_max. Returns (scores (B, k), ids (B, k) int32, blocks_read)."""
    n = items_sorted.shape[0]
    nb = bounds.shape[0]
    state_norm = torch.sqrt(torch.sum(state * state, dim=-1))   # (B,)
    scores, ids = _init(state, k)
    bi = 0
    while bi < nb and bool((state_norm * bounds[bi] > scores[:, -1]).any()):
        lo, hi = bi * block, min(bi * block + block, n)
        s = state @ items_sorted[lo:hi].T
        real_ids = item_order[lo:hi].to(torch.int32)
        scores, ids = _merge_topk(scores, ids, s, real_ids.expand_as(s), k)
        bi += 1
    return scores, ids, bi


def _merge_shards(mesh, parts: list, k: int):
    """One k-wide gather of every shard's (scores, ids) to the mesh's first
    position and their top-k over the (B, S·k) concatenation."""
    dev = mesh.devices.flat[0]
    s = torch.cat([p[0].to(dev) for p in parts], dim=-1)
    i = torch.cat([p[1].to(dev) for p in parts], dim=-1)
    top_s, pos = _stable_topk(s, k)
    return top_s, torch.gather(i, -1, pos)


def _dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _spmd(scan, state, catalog: tuple, axis: str, k: int):
    """One rank's part of a sharded retrieval over DTensors: `scan(state,
    *blocks, shard)` over this rank's blocks of `catalog` (its state rows),
    then the shards' (scores, ids) all-gathered over `axis` and merged."""
    from torch.distributed._functional_collectives import all_gather_tensor
    dmesh = catalog[0].device_mesh
    dim = dmesh.mesh_dim_names.index(axis)
    local = state.to_local() if _dtensor(state) else state
    scores, ids, *rest = scan(local, *(c.to_local() for c in catalog),
                              dmesh.get_local_rank(dim))
    s = all_gather_tensor(scores, 1, (dmesh, dim))
    i = all_gather_tensor(ids, 1, (dmesh, dim))
    top_s, pos = _stable_topk(s, k)
    return (top_s, torch.gather(i, -1, pos), *rest)


def streak_topk_sharded(state, items_sorted, item_order, bounds,
                        mesh, axis: str = "model", k: int = 100,
                        block: int = 65536):
    """Catalog-sharded STREAK retrieval: each `axis` shard runs the
    early-terminating scan over its own block set on its device, then one
    k-wide gather merges the shards' top-k; no catalog block crosses
    devices.

    `items_sorted`, `item_order` and `bounds` are cut as `P(axis)` cuts
    them (or come as `ShardedTensor`s laid out so, resident): shard i owns
    blocks [i·nb/S, (i+1)·nb/S); a size that S does not divide raises
    `ValueError`. `state` is replicated. Returns (scores, ids) on the
    mesh's first position and the blocks read, the largest count of any
    shard (the reference's `pmax`)."""
    items = shard_blocks(items_sorted, mesh, axis)
    orders = shard_blocks(item_order, mesh, axis)
    bnds = shard_blocks(bounds, mesh, axis)
    parts, read = [], 0
    for it, order, bd in zip(items, orders, bnds):
        scores, ids, bi = streak_topk(state.to(it.device), it, order, bd,
                                      k=k, block=block)
        parts.append((scores, ids))
        read = max(read, bi)
    return (*_merge_shards(mesh, parts, k), read)


def blocked_topk_sharded(state, items, mesh, axis: str = "model",
                         k: int = 100, block: int = 65536):
    """Catalog-sharded bulk scoring: each `axis` shard scans its own item
    rows (shard i from row i·(N // S), `P(axis, None)`; an N that S does
    not divide raises `ValueError`) on its device in blocks of at most
    `block`, then one k-wide merge. Returns (scores, ids) on the mesh's
    first position."""
    n = items.shape[0]
    if _dtensor(items):
        per = n // mesh.shape[axis]

        def scan(st, it, shard):
            scores, ids = blocked_topk(st, it, k=k,
                                       block=min(block, it.shape[0]))
            return scores, ids + shard * per
        return _spmd(scan, state, (items,), axis, k)
    parts = []
    for i, it in enumerate(shard_blocks(items, mesh, axis)):
        scores, ids = blocked_topk(state.to(it.device), it, k=k,
                                   block=min(block, it.shape[0]))
        parts.append((scores, ids + i * (n // mesh.shape[axis])))
    return _merge_shards(mesh, parts, k)
