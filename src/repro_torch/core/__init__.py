"""STREAK core on PyTorch: index, storage and the block query engine.

- index: SQuadTree (squadtree), identifier codec (ids), Z-order (morton),
  characteristic sets + Blooms (charsets), node selection DP (node_select)
- storage: QuadStore + permutation/numeric indexes (store), dictionary
- engine: Query AST (query), planner, APS (aps), block executor (executor),
  top-k (topk), spatial join phases (spatial_join), query shapes (shapes)
- baselines: sync R-tree join, full-scan engine (baselines, rtree); not
  re-exported here, as in the reference
- fault tolerance: failover chains, breakers, deadlines, injection (fault)
- scale-out: Morton-prefix sharding + compressed E-list tier (shard)
"""
from .executor import ExecConfig, ExecStats, StreakEngine  # noqa: F401
from .fault import FaultPlan, FaultRule, QueryDeadline  # noqa: F401
from .join import Relation  # noqa: F401
from .policy import BackendPolicy  # noqa: F401
from .query import Query, Ranking, SpatialFilter, TriplePattern, Var  # noqa: F401
from .shard import ShardedQuadStore, shard_store  # noqa: F401
from .store import QuadStore, build_store  # noqa: F401

__all__ = [
    "BackendPolicy", "ExecConfig", "ExecStats", "FaultPlan", "FaultRule",
    "Query", "QuadStore", "QueryDeadline", "Ranking", "Relation",
    "ShardedQuadStore", "SpatialFilter", "StreakEngine", "TriplePattern",
    "Var", "build_store", "shard_store",
]
