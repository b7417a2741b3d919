"""Morton-prefix sharding of the S-QuadTree store.

The object SoA of an `SQuadTree` is sorted by (S, Z, I, L) id, and the id
codec makes any subtree one contiguous id interval, so any contiguous split
of the sorted object array is a set of Morton-prefix ranges, and each range
rebuilds into a self-contained per-shard `SQuadTree` that keeps the GLOBAL
ids (`build(oids=...)`). Phases 1-2 then run per shard: candidate search and
node selection against the shard's own (smaller) tree, SIP filter material
clipped to the shard's id range so the per-shard driven retrievals
partition the result set exactly. The union over shards equals the
unsharded engine's answer, and the global θ read between shard passes
prunes later shards (the θ bound is exact).

The fused descent lays the shard axis over a shard mesh
(`launch/mesh.make_shard_mesh`) as the reference's `shard_map` lays it:
each of the mesh's d positions holds S/d contiguous shards' node planes,
resident on its device for the life of the shard set, and makes one
`ops.tree_descend_sharded` call (one launch of the descent kernel over its
S/d x N_max node columns) on that device (`descend_over_mesh`); the masks
come back to the engine's device. The mesh is the engine's device alone,
so one call over all S x N_max columns, unless the shard set was given its
own (`ShardedQuadStore.on_mesh`), e.g. `make_shard_mesh(S)` over every
card.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from .. import tracing
from ..kernels import ops
from ..launch.mesh import (Mesh, NamedSharding, PartitionSpec, ShardedTensor,
                           make_shard_mesh)
from . import geometry, node_select, squadtree
from .squadtree import SQuadTree, build as build_tree
from .store import QuadStore, _entity_cs_csr, _sorted_lut, lut_get


@dataclasses.dataclass
class TreeShard:
    """One shard's tree plus the closed global-id range it owns.

    `filter_material` clips the I-Range intervals to [id_lo, id_hi]: a
    shard tree's upper nodes (root included) span the whole id space, so
    without the clip two shards would both emit the driven rows of ids
    they don't own and the union would double-count. E-list ids need no
    clip: shard E-lists are built from shard-owned objects only.

    ``clip=False`` marks the single view over an unsharded store: filter
    material passes through untouched.
    """
    tree: SQuadTree
    id_lo: int = 0
    id_hi: int = 0
    clip: bool = True

    def filter_material(self, v_star: np.ndarray
                        ) -> tuple[np.ndarray, np.ndarray]:
        intervals, explicit = self.tree.filter_material(v_star)
        if self.clip and len(intervals):
            lo = np.maximum(intervals[:, 0], self.id_lo)
            hi = np.minimum(intervals[:, 1], self.id_hi)
            keep = lo <= hi
            intervals = np.stack([lo[keep], hi[keep]], axis=1)
        return intervals, explicit


class ShardSet(tuple):
    """A sharded store's fixed shards, the shard mesh its descent runs over
    (`mesh`, None for `make_shard_mesh`'s default), and the stacked descent
    planes made from them once per device and span of shards (`planes`,
    filled by `stacked_node_planes`)."""

    def __new__(cls, shards=(), mesh: Mesh | None = None):
        self = super().__new__(cls, shards)
        self.planes = {}
        self.mesh = mesh
        return self


def shard_views(store: QuadStore) -> ShardSet | list[TreeShard]:
    """The store's shard set; a single no-clip view for unsharded stores."""
    shards = getattr(store, "tree_shards", None)
    if shards:
        return shards
    return [TreeShard(store.tree, clip=False)]


def whole_view(store: QuadStore) -> list[TreeShard]:
    """Single global-tree view (the SIP-disabled path: with no interval
    filtering, per-shard retrieval would replicate the driven side)."""
    return [TreeShard(store.tree, clip=False)]


@dataclasses.dataclass
class ShardedQuadStore(QuadStore):
    """A QuadStore whose SQuadTree is partitioned by Morton-prefix range.

    The global `tree` is retained for id-keyed lookups that are not part
    of the per-shard Phase 1-2 sweep (`spatial_box_of`, `geom_rows`, the
    geometry pool rows); `tree_shards` carries the per-shard trees the
    executor iterates. Each shard tree has its own device copies (Bloom
    banks, node key planes), made at its first use on a device, and the
    shard set keeps the stacked descent planes of all its trees.
    """
    tree_shards: ShardSet = dataclasses.field(default_factory=ShardSet)

    def __post_init__(self):
        if not isinstance(self.tree_shards, ShardSet):
            self.tree_shards = ShardSet(self.tree_shards)

    def on_mesh(self, mesh: Mesh) -> ShardedQuadStore:
        """This store with its descent laid over the shard mesh `mesh`: the
        same shard trees, the descent planes made anew for the mesh."""
        return dataclasses.replace(
            self, tree_shards=ShardSet(self.tree_shards, mesh))

    @property
    def n_shards(self) -> int:
        return len(self.tree_shards)

    def shard_tree_nbytes(self) -> int:
        return sum(sh.tree.nbytes() for sh in self.tree_shards)


def shard_store(store: QuadStore, n_shards: int,
                leaf_capacity: int = 64,
                compressed: bool = True) -> ShardedQuadStore:
    """Partition `store` into `n_shards` contiguous Morton-prefix ranges.

    Each shard rebuilds a plain `SQuadTree` over its object slice with the
    precomputed GLOBAL ids and the global extent/l_max/Bloom geometry, so
    id-interval semantics (and the one shared `PreparedKeys`) carry over
    unchanged. Per-entity in/out characteristic sets are recomputed from
    the remapped quads; the remap is bijective, so the sets equal the
    build-time ones. ``compressed`` packs each shard's E-list tier
    (`SQuadTree.pack_elists`).

    Shards are equal-object-count splits; empty ranges (more shards than
    objects) are dropped. The sharded store shares the unsharded store's
    arrays, global tree included; the shard trees are new objects, so none
    of their device copies aliases the global tree's.
    """
    tree = store.tree
    if tree is None:
        raise ValueError("cannot shard a store with no spatial index")
    m = tree.n_objects
    n_shards = max(1, int(n_shards))
    bounds = [round(i * m / n_shards) for i in range(n_shards + 1)]
    cs_keys, cs_vals = _sorted_lut(store.cs_of_entity)
    bank = tree.bloom_self
    shards: list[TreeShard] = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        if b <= a:
            continue
        oids = tree.obj_ids[a:b]
        cs_self = lut_get(cs_keys, cs_vals, oids)
        cs_in, cs_out = _entity_cs_csr(store.quads, oids, cs_keys, cs_vals)
        sub = build_tree(
            tree.obj_entity[a:b], tree.obj_mbr[a:b], cs_self,
            cs_in=cs_in, cs_out=cs_out,
            extent=tree.extent, l_max=tree.l_max,
            leaf_capacity=leaf_capacity,
            bloom_words=bank.nbits // 32, bloom_k=bank.k,
            oids=oids, boxes_normalized=True, compressed=compressed)
        shards.append(TreeShard(sub, id_lo=int(oids[0]), id_hi=int(oids[-1])))
    fields = {f.name: getattr(store, f.name)
              for f in dataclasses.fields(QuadStore)}
    return ShardedQuadStore(**fields, tree_shards=shards)


# ---------------------------------------------------------------------------
# Sharded Phases 1-2
# ---------------------------------------------------------------------------

def stacked_node_planes(shards: ShardSet, device: torch.device,
                        lo: int = 0, hi: int | None = None) -> torch.Tensor:
    """Shards lo..hi-1's node key planes stacked for
    `ops.tree_descend_sharded`: (hi - lo, 4, N_max) int64 on `device`, N_max
    the largest tree of the whole set, pad columns `DESCEND_PAD_BOX`, as a
    transposed view of one contiguous (4, hi - lo, N_max) tensor, so the
    kernel reads them without a copy. The trees are immutable: built and
    uploaded once per shard set, device and span, kept in
    `shards.planes`."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    hi = len(shards) if hi is None else hi
    planes = shards.planes.get((device, lo, hi))
    if planes is None:
        n_max = max(sh.tree.n_nodes for sh in shards)
        host = np.empty((4, hi - lo, n_max), dtype=np.int64)
        host[:] = ops.DESCEND_PAD_BOX[:, None, None]
        for si, sh in enumerate(shards[lo:hi]):
            host[:, si, :sh.tree.n_nodes] = ops.f64_sort_keys(
                np.ascontiguousarray(sh.tree.node_mbr.T))
        planes = shards.planes[device, lo, hi] = \
            ops.upload(host, device, "tree_descend")
    return planes.transpose(0, 1)


def descent_mesh(shards: ShardSet, device: torch.device) -> Mesh:
    """The shard mesh the fused descent runs over: the set's own, else the
    engine's `device` alone (one position holding every shard)."""
    if shards.mesh is not None:
        return shards.mesh
    return make_shard_mesh(len(shards), [device])


def placed_node_planes(shards: ShardSet, mesh: Mesh) -> ShardedTensor:
    """Every shard's stacked node planes laid out `P("shard")` over the
    shard mesh `mesh`: position p holds its S/d contiguous shards' planes
    (`stacked_node_planes`) on its device. A mesh whose size does not
    divide S raises `ValueError`."""
    n_max = max(sh.tree.n_nodes for sh in shards)
    shape = (len(shards), 4, n_max)
    sharding = NamedSharding(mesh, PartitionSpec("shard"))
    sharding.check(shape)
    blocks = np.empty(mesh.devices.shape, dtype=object)
    for pos in mesh.positions():
        span = sharding.block_slices(shape, pos)[0]
        blocks[pos] = stacked_node_planes(shards, mesh.devices[pos],
                                          span.start, span.stop)
    return ShardedTensor(blocks, sharding, shape, torch.int64)


def descend_over_mesh(placed: ShardedTensor, cs_path: torch.Tensor,
                      box_keys: torch.Tensor) -> torch.Tensor:
    """The sharded descent over the mesh `placed` is laid out over: each
    position's (S/d, 4, N_max) planes, its shards' cs_path rows and the
    boxes on its device, one `ops.tree_descend_sharded` call there (kernel
    on a card, else the plain version; each call its own chain); the
    (S, B, N_max) masks concatenated on box_keys' device."""
    if placed.sharding.spec.axes(0) != ("shard",):
        raise ValueError(f"descend_over_mesh: planes laid out "
                         f"{placed.sharding.spec!r}; needs P('shard')")
    masks, lo = [], 0
    for planes in placed.along("shard"):
        dev, k = planes.device, planes.shape[0]
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            masks.append(ops.tree_descend_sharded(
                planes, cs_path[lo:lo + k].to(dev),
                box_keys.to(dev)).to(box_keys.device))
        lo += k
    return masks[0] if len(masks) == 1 else torch.cat(masks)


def candidate_nodes_sharded(shards: list[TreeShard], box_sets, dist_norm,
                            driven_cs: np.ndarray,
                            prepared=None, probe_backend=None,
                            descend_backend=None,
                            cs_paths: list | None = None,
                            device: torch.device | str | None = None
                            ) -> list[np.ndarray]:
    """Per-shard Phase-1 candidate masks for one shared CS set.

    Returns a list aligned with `shards` of (B, N_s) bool masks. The host
    frontier route (and a single shard) loops shards, each batched over
    blocks; the kernel route stacks each shard mesh position's node planes
    into ONE `ops.tree_descend_sharded` call on its device
    (`descend_over_mesh`; the chain's fallback is a per-shard loop), and
    on the engine's `device` alone that is one call over every shard. Both
    give the masks each shard's `candidate_nodes` gives alone.
    """
    driven_cs = np.asarray(driven_cs, dtype=np.int64)
    dback = squadtree.resolve_descend_backend(descend_backend)
    if cs_paths is None:
        cs_paths = [None] * len(shards)
    if dback == "numpy" or len(shards) == 1:
        return [sh.tree.candidate_nodes(
                    box_sets, dist_norm, driven_cs, prepared=prepared,
                    probe_backend=probe_backend, descend_backend=dback,
                    cs_path=cs_paths[si], device=device)
                for si, sh in enumerate(shards)]
    if device is None:
        raise ValueError("the fused descent needs a device")
    device = torch.device(device)
    boxes = squadtree._pad_box_sets(box_sets)
    n_b = len(boxes)
    sizes = [sh.tree.n_nodes for sh in shards]
    if not (n_b and len(driven_cs) and boxes.shape[1]):
        return [np.zeros((n_b, n), dtype=bool) for n in sizes]
    paths = [cs_paths[si] if cs_paths[si] is not None
             else sh.tree.cs_path_mask(driven_cs, prepared=prepared,
                                       probe_backend=probe_backend,
                                       device=device)
             for si, sh in enumerate(shards)]
    cs_stack = np.zeros((len(shards), max(sizes)), dtype=bool)
    for si, path in enumerate(paths):
        cs_stack[si, :sizes[si]] = path
    d = (dist_norm if np.ndim(dist_norm) == 0
         else np.asarray(dist_norm, dtype=np.float64)[:, None])
    expanded = geometry.expand_boxes(boxes, d)
    keys = ops.f64_sort_keys(expanded)
    pad = ~np.isfinite(boxes[..., 0])
    if pad.any():
        keys[pad] = ops.DESCEND_PAD_BOX
    if not isinstance(shards, ShardSet):
        shards = ShardSet(shards)
    masks = descend_over_mesh(
        placed_node_planes(shards, descent_mesh(shards, device)),
        ops.upload(cs_stack, device, "tree_descend"),
        ops.upload(keys, device, "tree_descend")).cpu().numpy()
    return [masks[si, :, :sizes[si]] for si in range(len(shards))]


@tracing.spanned("sip.select")
def sip_select(shards: list[TreeShard], box_sets, dist_norm,
               driven_cs: np.ndarray, prepared, probe_backend,
               descend_backend, cs_paths, params, card_all: list,
               device: torch.device) -> list[list[np.ndarray]]:
    """Phases 1+2 across shards: candidate masks then the per-shard V*
    selection DP. Returns per-BLOCK lists of per-shard V* arrays (the
    shape `QueryCursor._vstars` stores)."""
    masks = candidate_nodes_sharded(
        shards, box_sets, dist_norm, driven_cs, prepared=prepared,
        probe_backend=probe_backend, descend_backend=descend_backend,
        cs_paths=cs_paths, device=device)
    per_shard = [node_select.select_batch(sh.tree, masks[si], driven_cs,
                                          params, card_all[si])
                 for si, sh in enumerate(shards)]
    n_blocks = len(masks[0]) if len(shards) else 0
    return [[per_shard[si][b] for si in range(len(shards))]
            for b in range(n_blocks)]
