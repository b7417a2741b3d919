"""Sharding rules: parameter, cache and optimizer-state layouts over a mesh.

The reference's `launch/cells.py` imports `dist.partitioning`, which the
reference never wrote (ROADMAP §3). This module holds the functions that
`cells.py` calls, built from the rules the reference states in its
docstrings:

- LM weights (`models/transformer.py:8-14`): embed (V, D) row-shards the
  vocabulary over "model"; wq/wk/wv and w_up/w_gate shard their output
  columns, wo and w_down their input rows; the untied lm_head (D, V)
  shards its vocabulary columns; norms replicate.
- MoE (`models/moe.py:12-16`): the expert axis E over "model"; the router
  and the shared experts as the dense FFN rules say.
- GNN (`models/gnn.py:9-12`): weights replicate, except the input
  projection of the large full graph (ogb_products), column-sharded over
  "model".
- SASRec (`models/sasrec.py:13-14`): the item table row-shards over
  "model".
- GraphCast and NequIP (`cells.py:303`): replicate; their widths are small.
- Optimizer moments (`train/optim.py:4`): like their parameters
  (`like_params`), or ZeRO-1 (`zero1_sharding`): a moment also splits its
  first replicated dimension that the data-parallel axes divide.

A rule that does not divide a dimension is dropped for that dimension
(replicated), never applied unevenly, where the reference's `NamedSharding`
would refuse it; so is a head split that the head count does not divide
(nemotron-4-15b's 8 and qwen3-moe's 4 KV heads on model = 16: wk and wv
replicate, as does the KV cache's head axis; ROADMAP §3).
"""
from __future__ import annotations

import math

from .. import pytree
from ..launch.mesh import NamedSharding, PartitionSpec as P

# (V, D) / (L, D, F) / (L, F, D) ... : the mesh axis each dimension takes
_LM_RULES = {
    "embed": ("model", None), "lm_head": (None, "model"),
    "wq": (None, None, "model"), "wk": (None, None, "model"),
    "wv": (None, None, "model"), "wo": (None, "model", None),
    "w_up": (None, None, "model"), "w_gate": (None, None, "model"),
    "w_down": (None, "model", None),
    "ws_up": (None, None, "model"), "ws_gate": (None, None, "model"),
    "ws_down": (None, "model", None),
    "we_gate": (None, "model", None, None),
    "we_up": (None, "model", None, None),
    "we_down": (None, "model", None, None),
}


def dp_axes(mesh) -> tuple:
    """The data-parallel axes the mesh has, outermost first: ("pod",
    "data"), ("data",) or ()."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def fit(mesh, shape, spec) -> NamedSharding:
    """`NamedSharding(mesh, spec)` with every entry whose axes do not divide
    its dimension (or that the mesh lacks) replaced by None."""
    out = []
    for n, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = _axes(entry)
        ok = axes and all(a in mesh.axis_names for a in axes) \
            and n % math.prod(mesh.shape[a] for a in axes) == 0
        out.append(entry if ok else None)
    return NamedSharding(mesh, P(*out))


def _rep(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def _by_name(abstract, mesh, rules: dict):
    """A sharding for each leaf of `abstract` (leaves with `.shape`) by the
    name of the dict key that holds it; unnamed leaves replicate."""
    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        rule = rules.get(name)
        return fit(mesh, node.shape, rule) if rule else _rep(mesh)
    return walk(abstract, None)


def _head_rules(cfg, mesh) -> dict:
    """The LM rules, less the head splits that `cfg`'s head counts do not
    divide: wq/wo with n_heads, wk/wv with n_kv_heads, split over "model"
    only where the heads (not just their columns) divide evenly."""
    rules = dict(_LM_RULES)
    if cfg is None or "model" not in mesh.axis_names:
        return rules
    m = mesh.shape["model"]
    if cfg.n_heads % m:
        rules.pop("wq")
        rules.pop("wo")
    if cfg.n_kv_heads % m:
        rules.pop("wk")
        rules.pop("wv")
    return rules


def lm_param_sharding(abstract_params, mesh, cfg=None):
    """The dense and MoE LM layouts (module docstring); given the config,
    attention weights whose heads "model" does not divide replicate."""
    return _by_name(abstract_params, mesh, _head_rules(cfg, mesh))


def kv_cache_sharding(mesh, n_kv_heads: int | None = None) -> NamedSharding:
    """The (L, B, S, Hkv, Dh) cache: batch over the data-parallel axes,
    heads over "model" where `n_kv_heads` is a multiple of it (or not
    given), else replicated over "model"."""
    heads = "model" if n_kv_heads is None \
        or n_kv_heads % mesh.shape["model"] == 0 else None
    return NamedSharding(mesh, P(None, dp_axes(mesh) or None, None, heads,
                                 None))


def gnn_param_sharding(abstract_params, mesh, shard_input: bool = False):
    """GCN/SAGE weights replicate; with `shard_input` (the large full
    graph) the first layer's projections column-shard over "model"."""
    out = pytree.tree_map(lambda _: _rep(mesh), abstract_params)
    if shard_input:
        first = abstract_params["layers"][0]
        out["layers"][0] = {k: fit(mesh, v.shape, (None, "model"))
                            for k, v in first.items()}
    return out


def graphcast_param_sharding(abstract_params, mesh):
    """GraphCast's weights replicate (d_hidden 512)."""
    return pytree.tree_map(lambda _: _rep(mesh), abstract_params)


def sasrec_param_sharding(abstract_params, mesh):
    """The item table row-shards over "model"; the rest replicates."""
    return _by_name(abstract_params, mesh, {"item_embed": ("model", None)})


def like_params(param_sharding):
    """Moments laid out as their parameters are."""
    return param_sharding


def zero1_sharding(param_sharding, abstract_params, mesh):
    """ZeRO-1 moments: each parameter's layout, plus the data-parallel axes
    on the first dimension that is replicated and that they divide; a
    moment with no such dimension keeps its parameter's layout."""
    dp = dp_axes(mesh)
    size = math.prod(mesh.shape[a] for a in dp)

    def one(s: NamedSharding, a):
        if not dp or size == 1:
            return s
        spec = list(s.spec) + [None] * (len(a.shape) - len(s.spec))
        for d, n in enumerate(a.shape):
            if spec[d] is None and n % size == 0:
                spec[d] = dp
                return NamedSharding(mesh, P(*spec))
        return s
    return pytree.tree_map(one, param_sharding, abstract_params)
