"""Build the port's store from another engine's store state.

`store_from_state` takes the arrays that make up a built STREAK store —
quads, permutation and numeric indexes, the S-QuadTree's node and object
arrays and Bloom words, the geometry pool and the dictionary — as plain
numpy arrays and scalars in one flat dict, and assembles the port's
`QuadStore` from them without rebuilding anything. Two engines can then
answer queries over the very same state: the weights carried across, for a
database. The keys (`<part>.<field>`):

- ``quads`` (n, 4) int64; ``index.<order>`` (n, 4) int64 per `store.ORDERS`
- ``numeric.preds`` (P,) int64, and per predicate id ``p``:
  ``numeric.<p>.{values,subjects,objects,facts,block_max,block_min}`` and
  the scalar ``numeric.<p>.block``
- ``cs_of_entity.{keys,values}`` int64; ``cs_catalog.{ids,offsets,preds}``
  (CSR of each CS id's sorted predicate ids)
- ``geometry_predicate``, ``block`` scalars; ``num_ids`` int64 /
  ``num_vals`` f64 (the numeric-literal lookup table)
- ``geom_pool.{points,offsets}``; ``exact_geoms.{ids,offsets,points}``
- ``dictionary.{terms,ids,numeric_ids,numeric_values}`` and scalar
  ``dictionary.next``
- ``tree.extent`` (4,) f64, scalar ``tree.l_max``, ``tree.<field>`` for
  every array field of `SQuadTree` in `TREE_FIELDS`,
  ``tree.bloom_{self,in,out}.bits`` with scalar ``.k``, and
  ``tree.cs_stats.{offsets,cs_ids,counts}``. A tree's E-lists are the raw
  CSR (``tree.elist_ids``) or, with ``tree.elist_ids`` empty, the packed
  tier: ``tree.packed.<field>`` for every array of `PACKED_FIELDS` and the
  scalar ``tree.packed.rank`` (1: the packed values are ranks into the
  tree's ``obj_ids``, 0: raw ids).
- a sharded store (`core/shard.ShardedQuadStore`): per shard ``i`` from 0,
  ``tree_shards.<i>.<...>`` with every ``tree.<...>`` key above but the
  extent and ``l_max`` (the shards keep the global tree's), and the scalars
  ``tree_shards.<i>.{id_lo,id_hi}``.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.charsets import BloomBank, NodeCSStats
from .core.dictionary import Dictionary
from .core.geometry import Extent
from .core.shard import ShardedQuadStore, TreeShard
from .core.squadtree import PackedEList, SQuadTree
from .core.store import ORDERS, GeomPool, NumericIndex, QuadStore

TREE_FIELDS = ("node_z", "node_level", "node_parent", "node_children",
               "node_cell", "node_mbr", "irange", "n_subtree",
               "elist_offsets", "elist_ids", "obj_ids", "obj_mbr",
               "obj_entity")
PACKED_FIELDS = ("nodes", "counts", "base", "width", "bit_off", "words")


def _csr_split(offsets: np.ndarray, values: np.ndarray) -> list:
    return [values[offsets[i]:offsets[i + 1]] for i in range(len(offsets) - 1)]


def _tree_from_state(state: dict, prefix: str = "tree") -> SQuadTree | None:
    """The tree under `prefix` (see the module docstring); the extent and
    ``l_max`` are always the global tree's."""
    if f"{prefix}.node_z" not in state:
        return None
    fields = {f: np.asarray(state[f"{prefix}.{f}"]) for f in TREE_FIELDS}
    banks = {w: BloomBank(np.asarray(state[f"{prefix}.bloom_{w}.bits"],
                                     dtype=np.uint32),
                          int(state[f"{prefix}.bloom_{w}.k"]))
             for w in ("self", "in", "out")}
    obj_ids, obj_entity = fields["obj_ids"], fields["obj_entity"]
    packed = None
    if f"{prefix}.packed.nodes" in state:
        packed = PackedEList(
            **{f: np.asarray(state[f"{prefix}.packed.{f}"])
               for f in PACKED_FIELDS},
            src=obj_ids if int(state[f"{prefix}.packed.rank"]) else None)
    return SQuadTree(
        extent=Extent(*(float(v) for v in state["tree.extent"])),
        l_max=int(state["tree.l_max"]),
        bloom_self=banks["self"], bloom_in=banks["in"],
        bloom_out=banks["out"],
        cs_stats=NodeCSStats(
            *(np.asarray(state[f"{prefix}.cs_stats.{c}"])
              for c in ("offsets", "cs_ids", "counts"))),
        entity_to_id=dict(zip(obj_entity.tolist(), obj_ids.tolist())),
        packed=packed, **fields)


def _shards_from_state(state: dict) -> list[TreeShard]:
    shards = []
    while f"tree_shards.{len(shards)}.id_lo" in state:
        prefix = f"tree_shards.{len(shards)}"
        shards.append(TreeShard(_tree_from_state(state, prefix),
                                id_lo=int(state[f"{prefix}.id_lo"]),
                                id_hi=int(state[f"{prefix}.id_hi"])))
    return shards


def _dictionary_from_state(state: dict) -> Dictionary:
    terms = [str(t) for t in state["dictionary.terms"]]
    ids = np.asarray(state["dictionary.ids"], dtype=np.int64).tolist()
    d = Dictionary(
        term_to_id=dict(zip(terms, ids)), id_to_term=dict(zip(ids, terms)),
        numeric_value=dict(zip(
            np.asarray(state["dictionary.numeric_ids"]).tolist(),
            np.asarray(state["dictionary.numeric_values"]).tolist())))
    d._next = int(state["dictionary.next"])
    return d


def store_from_state(state: dict) -> QuadStore:
    """The port's `QuadStore` over the given arrays (see module docstring),
    a `ShardedQuadStore` where the state holds shards.

    Arrays are used as given (no copies), so the caller must not mutate them
    while the store is in use."""
    numeric = {}
    for p in np.asarray(state["numeric.preds"], dtype=np.int64).tolist():
        f = {c: np.asarray(state[f"numeric.{p}.{c}"])
             for c in ("values", "subjects", "objects", "facts",
                       "block_max", "block_min")}
        numeric[p] = NumericIndex(block=int(state[f"numeric.{p}.block"]), **f)
    cat_preds = _csr_split(np.asarray(state["cs_catalog.offsets"]),
                           np.asarray(state["cs_catalog.preds"]))
    exact = _csr_split(np.asarray(state["exact_geoms.offsets"]),
                       np.asarray(state["exact_geoms.points"]))
    shards = _shards_from_state(state)
    extra = dict(tree_shards=shards) if shards else {}
    return (ShardedQuadStore if shards else QuadStore)(
        quads=np.asarray(state["quads"]),
        dictionary=_dictionary_from_state(state),
        indexes={name: np.asarray(state[f"index.{name}"]) for name in ORDERS},
        numeric=numeric,
        tree=_tree_from_state(state),
        cs_of_entity=dict(zip(
            np.asarray(state["cs_of_entity.keys"]).tolist(),
            np.asarray(state["cs_of_entity.values"]).tolist())),
        cs_catalog={int(c): frozenset(int(x) for x in preds) for c, preds
                    in zip(np.asarray(state["cs_catalog.ids"]).tolist(),
                           cat_preds)},
        geometry_predicate=int(state["geometry_predicate"]),
        exact_geoms=dict(zip(
            np.asarray(state["exact_geoms.ids"]).tolist(), exact)),
        geom_pool=GeomPool(np.asarray(state["geom_pool.points"]),
                           np.asarray(state["geom_pool.offsets"])),
        block=int(state["block"]),
        _num_ids=np.asarray(state["num_ids"]),
        _num_vals=np.asarray(state["num_vals"]),
        **extra,
    )


def _tensor_from_array(a, device) -> torch.Tensor:
    """One array of another framework's state as a torch tensor. bfloat16
    arrays (numpy's `ml_dtypes.bfloat16`, which torch.from_numpy refuses)
    cross as their 16-bit patterns."""
    a = np.array(a)                   # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_state(params: dict, cfg, device) -> dict:
    """A model's parameters from the reference's parameter pytree as nested
    dicts and lists of numpy arrays, on `device`, for any config of
    `configs.registry`: the dense transformer's (stacked (L, ...) layer
    weights), the MoE's (padded expert stacks (L, E, ...), router, shared
    experts), SASRec's (`blocks` a list), the GNNs' (`layers` a list),
    GraphCast's (stacked processor weights) and NequIP's (`layers` a
    list). Every leaf keeps its dtype; the layout is the reference's, so
    the model module reads them as they are. Raises on a key, a list length
    or a leaf shape that the config's `param_shapes` does not give."""
    from .configs import registry
    want = registry.model_module(cfg).param_shapes(cfg)

    def walk(src, ref_tree, path):
        if isinstance(ref_tree, dict):
            if not isinstance(src, dict) or set(src) != set(ref_tree):
                raise ValueError(f"parameter keys at {path or 'top'}: "
                                 f"{sorted(src)} != {sorted(ref_tree)}")
            return {k: walk(v, ref_tree[k], f"{path}{k}.")
                    for k, v in src.items()}
        if isinstance(ref_tree, list):
            if not isinstance(src, (list, tuple)) \
                    or len(src) != len(ref_tree):
                raise ValueError(f"{path or 'top'}: {len(src)} items != "
                                 f"{len(ref_tree)}")
            return [walk(v, r, f"{path}{i}.")
                    for i, (v, r) in enumerate(zip(src, ref_tree))]
        t = _tensor_from_array(src, device)
        if tuple(t.shape) != ref_tree:
            raise ValueError(f"{path[:-1]}: shape {tuple(t.shape)} != "
                             f"{ref_tree}")
        return t

    return walk(params, want, "")
